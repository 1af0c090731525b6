"""The harness's plain depression-free fill (Planchon and Darboux 2002).

``W`` starts at the elevation on the outlets (the tile's rim and every
pixel next to the sea) and at +inf elsewhere, and every step lowers each
land pixel to ``max(elev, min(W of its 8 neighbours) + eps)``.  The fixed
point is the lowest surface above the elevation on which every land pixel
has a neighbour at least ``eps`` lower, or the sea: no pit and no flat.
It takes as many steps as the longest drainage path has pixels, each a few
launches on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbour_min(W):
    """The smallest of each pixel's 3x3 window (itself included), +inf
    outside the canvas."""
    return -F.max_pool2d(-W[None, None], 3, stride=1, padding=1)[0, 0]


def epsilon_fill(elev, sea=None, eps=1e-3, check_every=64):
    """The filled canvas (same dtype and device as ``elev``); ``sea``
    (bool, or None) marks pixels that are outlets and not land: they come
    back unchanged.  ``eps`` must exceed half a unit in the last place of
    the highest elevation, or the drop would round away."""
    n, m = elev.shape
    if sea is None:
        sea = torch.zeros_like(elev, dtype=torch.bool)
    inf = torch.tensor(float("inf"), dtype=elev.dtype, device=elev.device)
    e = torch.where(sea, 0.0, elev)
    rim = torch.zeros_like(sea)
    rim[0, :] = rim[-1, :] = rim[:, 0] = rim[:, -1] = True
    fixed = rim | sea
    W = torch.where(rim, e, inf)
    W = torch.where(sea, -inf, W)
    for _ in range(0, 8 * (n + m) * max(n, m), check_every):
        prev = W
        for _ in range(check_every):
            cand = torch.maximum(e, neighbour_min(W) + eps)
            W = torch.where(fixed, W, torch.minimum(W, cand))
        if torch.equal(W, prev):
            return torch.where(sea, elev, W)
    raise RuntimeError("epsilon_fill did not converge")


def interior_pits(elev, sea=None):
    """The number of land pixels off the rim with no neighbour strictly
    lower (a pit or a flat), the sea counting as lower."""
    if sea is None:
        sea = torch.zeros_like(elev, dtype=torch.bool)
    inf = torch.tensor(float("inf"), dtype=elev.dtype, device=elev.device)
    W = torch.where(sea, -inf, elev)
    lower = neighbour_min(W) < W
    return int((~lower & ~sea)[1:-1, 1:-1].sum())
