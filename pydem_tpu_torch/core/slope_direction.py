"""D-infinity (Tarboton) slope magnitude and flow direction, and the flat
extension by label flood.

Port of ``pydem_tpu/core/slope_direction.py``: one vectorized 8-facet sweep
over NaN-filled neighbor shifts, with the edge/corner facet subsets as static
region masks, plus the reference's sequential "upstream-facing edges copy the
interior value" steps in the same left → right → top → bottom order.

On a CUDA device the sweep of a float32 or float64 grid of at least 2×2 is
one hand-written kernel pair (:func:`~pydem_tpu_torch.ops.facets.facet_sweep`,
``ops/csrc/facets.cu``), bit for bit the eager sweep below
(:func:`_slopes_directions_eager`), which runs everywhere else.  Likewise
the flood's labels of a CUDA mask come from a union-find kernel
(:func:`~pydem_tpu_torch.ops.flood.flood_labels`, ``ops/csrc/flood.cu``),
those of any other from the eager loop (:func:`_label_flood_eager`).

Eager PyTorch runs one kernel per operation, so ``a*a + b*b`` is never
contracted into an FMA: the JAX version's ``optimization_barrier`` calls have
no counterpart here.  Write the arithmetic as plain operations (no
``addcmul``, no ``torch.compile``) to keep it that way.  Square roots go
through :func:`~pydem_tpu_torch.core.stencil.sqrt_rn`, correctly rounded on
every device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.facets import DTYPES, facet_sweep
from ..ops.flood import flood_labels
from ..profiling import count, span
from .stencil import (ANG_ADJ, FACET_E1, FACET_E2, NEIGHBOR_OFFSETS, shift,
                      sqrt_rn)

FLAT_ID_INT = -1

# facet -> d1 runs along X (d1=dX, d2=dY) for facets 0,3,4,7; swapped else.
_D1_IS_DX = (True, False, False, True, True, False, False, True)
# facet -> whether its diagonal neighbor points up (fence row i-1) or down
# (fence row i).
_ROW_IS_UP = (True, True, True, True, False, False, False, False)


def _facet_row_distances(dX, dY, n):
    """Per-facet (d1, d2) column vectors of shape (n, 1).

    dX/dY are 'fence' arrays of length n-1; row i of an up-facet uses fence
    index i-1, of a down-facet index i, clipped to [0, n-2].
    """
    i = torch.arange(n, device=dX.device)
    up = torch.clamp(i - 1, 0, n - 2)
    dn = torch.clamp(i, 0, n - 2)
    dX_up, dY_up = dX[up][:, None], dY[up][:, None]
    dX_dn, dY_dn = dX[dn][:, None], dY[dn][:, None]
    out = []
    for ind in range(8):
        dx, dy = (dX_up, dY_up) if _ROW_IS_UP[ind] else (dX_dn, dY_dn)
        d1, d2 = (dx, dy) if _D1_IS_DX[ind] else (dy, dx)
        out.append((d1, d2))
    return out


def _region_masks(n, m, device):
    """Facet-validity masks: allowed[ind][i,j] iff facet ind's e1 and e2
    neighbors are both inside the grid.  Built on the device from a row and
    a column index (the JAX version builds them once per compile with
    numpy; eagerly that costs a second of host time per call at 2048²)."""
    ii = torch.arange(n, device=device)[:, None]
    jj = torch.arange(m, device=device)[None, :]
    allowed = []
    for ind in range(8):
        ok = torch.ones((n, m), dtype=torch.bool, device=device)
        for (di, dj) in (FACET_E1[ind], FACET_E2[ind]):
            ok = (ok & (ii + di >= 0) & (ii + di < n)
                  & (jj + dj >= 0) & (jj + dj < m))
        allowed.append(ok)
    interior = (ii >= 1) & (ii < n - 1) & (jj >= 1) & (jj < m - 1)
    return allowed, interior


def _facet_candidates(elev, d1, d2, ind):
    """(rad2, r) candidate squared slope / in-facet angle for facet ``ind``
    at every pixel, with the reference's special cases."""
    e1 = shift(elev, *FACET_E1[ind])
    e2 = shift(elev, *FACET_E2[ind])
    s1 = (elev - e1) / d1
    s2 = (e1 - e2) / d2
    s1_2 = s1 * s1
    s2_2 = s2 * s2
    d1_2 = d1 * d1
    hyp = sqrt_rn(d1_2 + d2 * d2)
    sd = (elev - e2) / hyp
    r = torch.atan2(s2, s1)
    rad2 = s1_2 + s2_2
    theta_b = torch.atan2(d2, d1).expand(elev.shape)

    b_s1_lte0 = s1 <= 0
    b_s2_lte0 = s2 <= 0
    b_s2_gt0 = s2 > 0

    # exact algebraic forms of the reference's transcendental comparisons
    # (theta in (0, pi/2), d1, d2 > 0), so atan2's last ulp cannot flip a
    # facet tie-break:
    #   r > theta  <=>  s2 > 0 and (s1 <= 0 or s2*d1 > s1*d2)
    #   r < 0      <=>  s2 < 0
    # on-diagonal case
    I1 = b_s2_gt0 & (b_s1_lte0 | (s2 * d1 > s1 * d2))
    rad2 = torch.where(I1, sd * sd, rad2)
    r = torch.where(I1, theta_b, r)
    # on-straight-edge case (disjoint from I1)
    I2 = (s2 < 0) | ((s2 == 0) & (s1 > 0))
    rad2 = torch.where(I2, s1_2, rad2)
    r = torch.where(I2, 0.0, r)
    # upslope or flat facet
    I3 = b_s1_lte0 & (b_s2_lte0 | (b_s2_gt0 & (sd <= 0)))
    rad2 = torch.where(I3, -1.0, rad2)
    return rad2, r


def _apply_facets(elev, mag, direction, dists, masks):
    """Run the 8-facet max-update restricted to ``masks[ind]``."""
    for ind in range(8):
        d1, d2 = dists[ind]
        rad2, r = _facet_candidates(elev, d1, d2, ind)
        upd = masks[ind] & (rad2 > mag)
        adj0, adj1 = int(ANG_ADJ[ind][0]), int(ANG_ADJ[ind][1])
        ang = r * adj1 + adj0 * (np.pi / 2)
        mag = torch.where(upd, rad2, mag)
        direction = torch.where(upd, ang, direction)
    return mag, direction


def slopes_directions(elev, dX, dY):
    """D∞ slope magnitude and direction for the whole grid.

    Returns (mag, direction); flats (all-upslope pixels) hold -1 in both.
    ``dX``/``dY``: scalars or the (n-1) spacings between rows.  A CUDA grid
    of a type in :data:`~pydem_tpu_torch.ops.facets.DTYPES`, 2×2 or larger,
    takes the kernel; the result is the eager sweep's either way.
    """
    n, m = elev.shape
    if (elev.device.type == "cuda" and elev.dtype in DTYPES and n >= 2
            and m >= 2):
        dX, dY = (torch.as_tensor(d, dtype=elev.dtype, device=elev.device)
                  .expand(n - 1).contiguous() for d in (dX, dY))
        return facet_sweep(elev.contiguous(), dX, dY)
    return _slopes_directions_eager(elev, dX, dY)


def _slopes_directions_eager(elev, dX, dY):
    """:func:`slopes_directions` as eager PyTorch operations, on any
    device and type."""
    n, m = elev.shape
    dX = torch.as_tensor(dX, dtype=elev.dtype, device=elev.device).expand(n - 1)
    dY = torch.as_tensor(dY, dtype=elev.dtype, device=elev.device).expand(n - 1)

    dists = _facet_row_distances(dX, dY, n)
    allowed, interior = _region_masks(n, m, elev.device)

    mag = torch.full((n, m), float(FLAT_ID_INT), dtype=elev.dtype,
                     device=elev.device)
    direction = torch.full_like(mag, float(FLAT_ID_INT))

    # Phase 1: interior pixels, all 8 facets.
    mag, direction = _apply_facets(elev, mag, direction, dists, [interior] * 8)

    # Phase 2: upstream-facing edges copy the adjacent interior value, in the
    # reference's sequential order; later steps observe earlier writes.
    # mag/direction are fresh tensors here, so they are updated in place.
    pi = np.pi
    ids = (direction[:, 1] > pi / 2) & (direction[:, 1] < 3 * pi / 2)
    direction[:, 0] = torch.where(ids, direction[:, 1], direction[:, 0])
    mag[:, 0] = torch.where(ids, mag[:, 1], mag[:, 0])

    ids = (direction[:, -2] < pi / 2) | (direction[:, -2] > 3 * pi / 2)
    direction[:, -1] = torch.where(ids, direction[:, -2], direction[:, -1])
    mag[:, -1] = torch.where(ids, mag[:, -2], mag[:, -1])

    ids = (direction[1, :] > 0) & (direction[1, :] < pi)
    direction[0, :] = torch.where(ids, direction[1, :], direction[0, :])
    mag[0, :] = torch.where(ids, mag[1, :], mag[0, :])

    ids = (direction[-2, :] > pi) & (direction[-2, :] < 2 * pi)
    direction[-1, :] = torch.where(ids, direction[-2, :], direction[-1, :])
    mag[-1, :] = torch.where(ids, mag[-2, :], mag[-1, :])

    # Phase 3: edge/corner pixels with their in-grid facet subsets, possibly
    # overriding the copies when a downstream facet has larger slope.
    border = [allowed[ind] & ~interior for ind in range(8)]
    mag, direction = _apply_facets(elev, mag, direction, dists, border)

    mag = torch.where(mag > 0, sqrt_rn(mag), mag)
    return mag, direction


# ---------------------------------------------------------------------------
# flat-region extension
# ---------------------------------------------------------------------------

def label_flood(mask, payload):
    """Connected-component labels (8-connectivity) by min-index flood, plus
    the payload value at the label-defining pixel carried to the whole region.

    Label of a region = smallest flattened index of its pixels; ``rep`` = the
    payload at that pixel.  Non-region pixels get label n*m / payload NaN.

    A CUDA mask takes the union-find kernel
    (:func:`~pydem_tpu_torch.ops.flood.flood_labels`, ``ops/csrc/flood.cu``:
    three launches, no host read); every other mask the eager loop
    (:func:`_label_flood_eager`).  The labels are defined uniquely, so both
    give the same integers.
    """
    with span("label_flood"):
        if mask.device.type == "cuda":
            lbl = flood_labels(mask)
            return lbl, _region_rep(mask, payload, lbl)
        return _label_flood_eager(mask, payload)


def _label_flood_eager(mask, payload):
    """:func:`label_flood` as eager PyTorch operations, on any device.

    Each iteration runs one min-sweep over the 8 neighbors; if it changed
    anything, a hook (``parent[lbl[p]] = min(parent[lbl[p]], sweep[p])``, a
    scatter-min that is order-independent and so deterministic on CUDA) and
    two compress gathers (``lbl <- lbl[lbl]``) follow.  The loop reads one
    flag on the host per iteration (the counter ``flood_iters``).
    """
    n, m = mask.shape
    N = n * m
    # int32 labels: beyond 2^31-1 pixels the clipped gathers would wrap.
    if N >= 2 ** 31:
        raise ValueError("label_flood: canvas has %d pixels >= 2^31; "
                         "int32 labels would overflow" % N)
    big = N
    dev = mask.device
    idx = torch.arange(N, dtype=torch.int32, device=dev).reshape(n, m)
    big_t = torch.tensor(big, dtype=torch.int32, device=dev)
    lbl = torch.where(mask, idx, big_t)
    mask_flat = mask.reshape(-1)

    def sweep(lbl):
        new_lbl = lbl
        for di, dj in NEIGHBOR_OFFSETS:
            new_lbl = torch.minimum(new_lbl, shift(lbl, di, dj, big))
        return torch.where(mask, new_lbl, big_t)

    def hook_and_compress(lbl, mins):
        lf = lbl.reshape(-1)
        # parent table indexed by pixel id; one slot of slack for `big`
        parent = torch.cat([lf, big_t.reshape(1)])
        tgt = torch.where(mask_flat, lf, N).long()
        parent.scatter_reduce_(0, tgt, mins.reshape(-1), reduce="amin")
        lbl = torch.where(mask, parent[:N].reshape(n, m), big_t)
        for _ in range(2):  # compress: lbl <- lbl[lbl]
            f = lbl.reshape(-1)
            lbl = torch.where(
                mask, f[torch.clamp(f, 0, N - 1).long()].reshape(n, m),
                big_t)
        return lbl

    while True:
        mins = sweep(lbl)
        count("flood_iters")
        if not bool((mins != lbl).any()):
            break
        lbl = hook_and_compress(lbl, mins)
    return lbl, _region_rep(mask, payload, lbl)


def _region_rep(mask, payload, lbl):
    """The payload at each mask pixel's label (NaN off the mask)."""
    n, m = mask.shape
    at = torch.clamp(lbl.reshape(-1), 0, n * m - 1).long()
    rep = payload.reshape(-1)[at]
    return torch.where(mask, rep.reshape(n, m), float("nan"))


def find_flats_edges(elev, mag):
    """Extend flats one pixel downstream.

    For each flat region (mag == -1), pixels 8-adjacent to the region become
    flat iff their elevation equals the region's representative elevation
    (first pixel in scan order); where several regions touch a pixel, the
    highest label wins.
    """
    flat = mag == FLAT_ID_INT
    lbl, rep = label_flood(flat, elev)

    neg = torch.tensor(-1, dtype=torch.int32, device=elev.device)
    lbl_m = torch.where(flat, lbl, neg)
    best_lbl = torch.full(elev.shape, -1, dtype=torch.int32,
                          device=elev.device)
    best_rep = torch.full_like(elev, float("nan"))
    for di, dj in NEIGHBOR_OFFSETS:
        nl = shift(lbl_m, di, dj, -1)
        nr = shift(rep, di, dj, float("nan"))
        better = nl > best_lbl
        best_lbl = torch.where(better, nl, best_lbl)
        best_rep = torch.where(better, nr, best_rep)

    return torch.where(best_lbl >= 0, elev == best_rep, flat)
