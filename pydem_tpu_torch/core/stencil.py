"""Shared 3×3 stencil utilities (shift helpers, neighbor tables).

Port of ``pydem_tpu/core/stencil.py``: every terrain stage is a combination
of the 8 single-pixel shifts defined here, written as ``F.pad`` plus a slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Neighbor offsets in (di, dj), indexed 0..7 counter-clockwise starting East
# (the Tarboton facet ring).
NEIGHBOR_OFFSETS = (
    (0, 1),    # 0: E
    (-1, 1),   # 1: NE
    (-1, 0),   # 2: N
    (-1, -1),  # 3: NW
    (0, -1),   # 4: W
    (1, -1),   # 5: SW
    (1, 0),    # 6: S
    (1, 1),    # 7: SE
)

OFFSET_INDEX = {off: k for k, off in enumerate(NEIGHBOR_OFFSETS)}

# Tarboton facet table: facet ind -> (e1, e2) neighbor offsets, and the angle
# adjustment per facet.
FACET_E1 = ((0, 1), (-1, 0), (-1, 0), (0, -1), (0, -1), (1, 0), (1, 0), (0, 1))
FACET_E2 = ((-1, 1), (-1, 1), (-1, -1), (-1, -1), (1, -1), (1, -1), (1, 1), (1, 1))
ANG_ADJ = np.array(
    [[0, 1], [1, -1], [1, 1], [2, -1], [2, 1], [3, -1], [3, 1], [4, -1]]
)


def shift(arr, di, dj, fill=float("nan")):
    """Value of the neighbor at offset (di, dj): out[i, j] = arr[i+di, j+dj]
    over the last two dimensions (leading dimensions are a batch).

    Out-of-bounds positions get ``fill`` (any dtype: float, integer, bool).
    """
    n, m = arr.shape[-2:]
    top, left = max(0, -di), max(0, -dj)
    p = F.pad(arr, (left, max(0, dj), top, max(0, di)), value=fill)
    return p[..., max(0, di): max(0, di) + n, max(0, dj): max(0, dj) + m]


def scatter_shift(arr, di, dj, fill=0.0):
    """Place arr[i, j] at [i+di, j+dj] (inverse of :func:`shift`)."""
    return shift(arr, -di, -dj, fill=fill)


def dilate(mask):
    """8-neighbour dilation of a boolean mask over its last two dimensions
    (``_dilate`` of ``pydem_tpu/ops/pit_growth.py``)."""
    out = mask
    for di, dj in NEIGHBOR_OFFSETS:
        out = out | shift(mask, di, dj, False)
    return out


def sqrt_rn(x):
    """Correctly rounded square root, as IEEE 754, numpy and the JAX package
    give it.

    PyTorch's CPU float64 ``sqrt`` is one ulp off for about 1% of inputs
    (``sqrt(2.0)`` among them); its CUDA ``sqrt`` is correctly rounded.  The
    facet tie-breaks compare squared slopes built on the diagonal length,
    where one ulp picks another facet, so the CPU takes numpy's.
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)
