"""Flow splitting: direction angle → receiver weights.

Port of ``pydem_tpu/core/receivers.py``: 8 dense per-neighbor weight planes
``W[k]``, where ``W[k][i, j]`` is the fraction of pixel (i, j)'s area sent to
the neighbor at ``NEIGHBOR_OFFSETS[k]``.  Every pixel has at most two nonzero
entries (its D∞ facet pair).  Entries are dropped for flats (NaN
proportion), weights ≤ 1e-8, out-of-grid receivers and uphill receivers.
"""
from __future__ import annotations

import numpy as np
import torch

from .stencil import ANG_ADJ, FACET_E1, FACET_E2, OFFSET_INDEX, shift

FLAT_ID_INT = -1


def section_theta(dX, dY, n):
    """Per-row facet-opening angle: ``atan2(dY, dX)[clip(i-1, 0, n-3)]`` as
    an (n, 1) column (interior fence rows, replicated at top and bottom)."""
    t = torch.atan2(dY[: n - 2], dX[: n - 2])
    i = torch.arange(n, device=t.device)
    return t[torch.clamp(i - 1, 0, n - 3)][:, None]


def section_proportion(direction, flats, dX=None, dY=None, theta=None):
    """Facet index (0-7) and straight-neighbor proportion per pixel; flats
    get section -1 / proportion NaN.

    ``theta`` optionally gives the per-row facet angle directly (n values):
    windowed callers need the *global* row angles, not the window-local
    fence clipping of :func:`section_theta`.
    """
    n, m = direction.shape

    def like(a):
        return torch.as_tensor(a, dtype=direction.dtype,
                               device=direction.device)

    if theta is None:
        theta = section_theta(like(dX), like(dY), n)
    else:
        theta = like(theta).reshape(n, 1)
    theta = theta.expand(n, m)
    pi = np.pi

    # divide by a tensor on the device: CUDA divides by a Python number as a
    # multiplication by its reciprocal, which moves exact quadrant
    # boundaries (direction = k·π/2) by an ulp
    quad_idx = torch.floor(direction / direction.new_tensor(pi) * 2.0).to(
        torch.int32)
    quadrant = direction - quad_idx.to(direction.dtype) * (pi / 2.0)

    # floor-mod, as in numpy: the flats' direction -1 gives quad_idx -1, odd
    even = quad_idx % 2 == 0
    section = (
        quad_idx * 2
        + ((quadrant > theta) & even).to(torch.int32)
        + ((quadrant > (pi / 2 - theta)) & ~even).to(torch.int32)
    )

    proportion = torch.full_like(direction, float("nan"))
    I1 = (section == 0) | (section == 1) | (section == 4) | (section == 5)
    proportion = torch.where(I1 & (quadrant <= theta), quadrant / theta,
                             proportion)
    proportion = torch.where(I1 & (quadrant > theta),
                             (quadrant - theta) / (pi / 2 - theta), proportion)
    proportion = torch.where(~I1 & (quadrant <= (pi / 2 - theta)),
                             quadrant / (pi / 2 - theta), proportion)
    proportion = torch.where(~I1 & (quadrant > (pi / 2 - theta)),
                             (quadrant - (pi / 2 - theta)) / theta, proportion)

    section = torch.where(flats, FLAT_ID_INT, section)
    proportion = torch.where(flats, float("nan"), proportion)
    section = torch.where(section == 8, 0, section)

    # numpy indexing: negative sections (-1 for flats, -2 for a non-flat
    # direction of -1) wrap to the end of the table
    adj = torch.as_tensor(ANG_ADJ[:, 1], dtype=direction.dtype,
                          device=direction.device)
    wrapped = torch.where(section < 0, section + 8, section).clamp(0, 7)
    adjust = adj[wrapped.long()]
    proportion = (1 + adjust) / 2.0 - adjust * proportion
    return section, proportion


def receiver_weights(section, proportion, elev):
    """Dense (8, n, m) receiver weight planes from section/proportion.

    ``W[k][p] > 0`` implies the neighbor at offset k is in-grid and at
    elevation <= elev[p].
    """
    W = [torch.zeros_like(elev) for _ in range(8)]
    for s in range(8):
        on = section == s
        for e_off, w in ((FACET_E1[s], proportion),
                         (FACET_E2[s], 1.0 - proportion)):
            k = OFFSET_INDEX[e_off]
            target_elev = shift(elev, *e_off)  # NaN outside the grid
            keep = on & (w > 1e-8) & (target_elev <= elev)
            W[k] = W[k] + torch.where(keep, w, 0.0)
    return torch.stack(W)
