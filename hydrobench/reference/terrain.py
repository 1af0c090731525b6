"""The terrain step in plain PyTorch, in any float dtype.

- D-infinity slope and direction (Tarboton 1997) with the reference
  pyDEM's facet tie-breaks and edge rules, the section/proportion split and
  the receiver weights: a frozen copy of the program's plain stencil code,
  so the two compute the same formulas.
- Flat regions (8-connected ``mag == -1``) labelled by
  ``scipy.ndimage.label`` on the host, each region represented by its
  first pixel in scan order, and the one-pixel downstream extension.
- The upstream contributing area solved directly in topological order
  (Kahn): a pixel's area is final once all its donors are, and is then
  pushed to its (at most two) receivers.  The program instead iterates a
  fixed point by block Gauss-Seidel rounds; on the drainage DAG both have
  the one solution.
- TWI = 10 ln(uca / (slope + 0.001)), NaN at flats.
- :func:`downstream`: the pixels a set of pixels sends area to, over the
  reference's graph, for the check's clean-pixel comparison.

Run in float64 it is the truth; run in bfloat16 it is the control that a
precision below the configuration's must fail.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

FLAT = -1
PLANES = ("mag", "direction", "flats", "uca", "twi")
# neighbour offsets (di, dj), counter-clockwise from east
OFFSETS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0),
           (1, 1))
OFFSET_INDEX = {off: k for k, off in enumerate(OFFSETS)}
FACET_E1 = ((0, 1), (-1, 0), (-1, 0), (0, -1), (0, -1), (1, 0), (1, 0), (0, 1))
FACET_E2 = ((-1, 1), (-1, 1), (-1, -1), (-1, -1), (1, -1), (1, -1), (1, 1),
            (1, 1))
ANG_ADJ = ((0, 1), (1, -1), (1, 1), (2, -1), (2, 1), (3, -1), (3, 1), (4, -1))
D1_IS_DX = (True, False, False, True, True, False, False, True)
ROW_IS_UP = (True, True, True, True, False, False, False, False)


def shift(a, di, dj, fill=float("nan")):
    """out[i, j] = a[i + di, j + dj], ``fill`` outside."""
    n, m = a.shape[-2:]
    p = F.pad(a, (max(0, -dj), max(0, dj), max(0, -di), max(0, di)),
              value=fill)
    return p[..., max(0, di): max(0, di) + n, max(0, dj): max(0, dj) + m]


def _sqrt(x):
    # correctly rounded on every device (the CPU's float64 torch.sqrt is
    # not, and one ulp picks another facet at a tie)
    if x.device.type == "cpu" and x.dtype == torch.float64:
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _facet_distances(dX, dY, n):
    i = torch.arange(n, device=dX.device)
    up, dn = torch.clamp(i - 1, 0, n - 2), torch.clamp(i, 0, n - 2)
    out = []
    for ind in range(8):
        rows = up if ROW_IS_UP[ind] else dn
        dx, dy = dX[rows][:, None], dY[rows][:, None]
        out.append((dx, dy) if D1_IS_DX[ind] else (dy, dx))
    return out


def _masks(n, m, device):
    ii = torch.arange(n, device=device)[:, None]
    jj = torch.arange(m, device=device)[None, :]
    allowed = []
    for ind in range(8):
        ok = torch.ones((n, m), dtype=torch.bool, device=device)
        for di, dj in (FACET_E1[ind], FACET_E2[ind]):
            ok = ok & (ii + di >= 0) & (ii + di < n) & (jj + dj >= 0) \
                & (jj + dj < m)
        allowed.append(ok)
    interior = (ii >= 1) & (ii < n - 1) & (jj >= 1) & (jj < m - 1)
    return allowed, interior


def _facet(elev, d1, d2, ind):
    e1, e2 = shift(elev, *FACET_E1[ind]), shift(elev, *FACET_E2[ind])
    s1 = (elev - e1) / d1
    s2 = (e1 - e2) / d2
    s1_2, s2_2 = s1 * s1, s2 * s2
    hyp = _sqrt(d1 * d1 + d2 * d2)
    sd = (elev - e2) / hyp
    r = torch.atan2(s2, s1)
    rad2 = s1_2 + s2_2
    theta = torch.atan2(d2, d1).expand(elev.shape)
    on_diag = (s2 > 0) & ((s1 <= 0) | (s2 * d1 > s1 * d2))
    rad2 = torch.where(on_diag, sd * sd, rad2)
    r = torch.where(on_diag, theta, r)
    on_edge = (s2 < 0) | ((s2 == 0) & (s1 > 0))
    rad2 = torch.where(on_edge, s1_2, rad2)
    r = torch.where(on_edge, 0.0, r)
    up = (s1 <= 0) & ((s2 <= 0) | ((s2 > 0) & (sd <= 0)))
    rad2 = torch.where(up, -1.0, rad2)
    return rad2, r


def _apply(elev, mag, direction, dists, masks):
    for ind in range(8):
        rad2, r = _facet(elev, *dists[ind], ind)
        upd = masks[ind] & (rad2 > mag)
        ang = r * ANG_ADJ[ind][1] + ANG_ADJ[ind][0] * (np.pi / 2)
        mag = torch.where(upd, rad2, mag)
        direction = torch.where(upd, ang, direction)
    return mag, direction


def slopes_directions(elev, dX, dY):
    """``(mag, direction)``; -1 in both where no facet falls."""
    n, m = elev.shape
    dists = _facet_distances(dX, dY, n)
    allowed, interior = _masks(n, m, elev.device)
    mag = torch.full((n, m), float(FLAT), dtype=elev.dtype, device=elev.device)
    direction = mag.clone()
    mag, direction = _apply(elev, mag, direction, dists, [interior] * 8)
    pi = np.pi
    # upstream-facing edges copy the interior value, in this order
    for (dst, src, test) in (
            ((slice(None), 0), (slice(None), 1),
             lambda d: (d > pi / 2) & (d < 3 * pi / 2)),
            ((slice(None), -1), (slice(None), -2),
             lambda d: (d < pi / 2) | (d > 3 * pi / 2)),
            ((0, slice(None)), (1, slice(None)), lambda d: (d > 0) & (d < pi)),
            ((-1, slice(None)), (-2, slice(None)),
             lambda d: (d > pi) & (d < 2 * pi))):
        ids = test(direction[src])
        direction[dst] = torch.where(ids, direction[src], direction[dst])
        mag[dst] = torch.where(ids, mag[src], mag[dst])
    border = [allowed[ind] & ~interior for ind in range(8)]
    mag, direction = _apply(elev, mag, direction, dists, border)
    return torch.where(mag > 0, _sqrt(mag.clamp_min(0)), mag), direction


def flats_extended(elev, mag):
    """Flat pixels (``mag == -1``) plus each pixel next to a flat region
    whose elevation equals the region's first pixel in scan order; where
    several regions touch a pixel, the one whose first pixel comes last
    wins."""
    flat = (mag == FLAT).cpu().numpy()
    n, m = flat.shape
    lab, count = scipy.ndimage.label(flat, structure=np.ones((3, 3), bool))
    first = np.full(count + 1, n * m, dtype=np.int64)
    idx = np.flatnonzero(flat)  # ascending: a label's first is its least
    labels, at = np.unique(lab.ravel()[idx], return_index=True)
    first[labels] = idx[at]
    dev = elev.device
    region = torch.from_numpy(np.where(flat, first[lab], -1)).to(dev)
    flat = torch.from_numpy(flat).to(dev)
    rep = elev.reshape(-1)[region.clamp(0, n * m - 1)]
    rep = torch.where(flat, rep, float("nan"))
    best = torch.full((n, m), -1, dtype=torch.int64, device=dev)
    best_rep = torch.full_like(elev, float("nan"))
    for di, dj in OFFSETS:
        nl = shift(region, di, dj, -1)
        better = nl > best
        best = torch.where(better, nl, best)
        best_rep = torch.where(better, shift(rep, di, dj), best_rep)
    return torch.where(best >= 0, elev == best_rep, flat)


def section_proportion(direction, flats, dX, dY):
    """Facet index and the straight neighbour's share; -1 / NaN at flats."""
    n, m = direction.shape
    t = torch.atan2(dY[: n - 2], dX[: n - 2])
    i = torch.arange(n, device=t.device)
    theta = t[torch.clamp(i - 1, 0, n - 3)][:, None].expand(n, m)
    pi = np.pi
    q_idx = torch.floor(direction / direction.new_tensor(pi) * 2.0).to(
        torch.int32)
    quadrant = direction - q_idx.to(direction.dtype) * (pi / 2.0)
    even = q_idx % 2 == 0
    section = (q_idx * 2 + ((quadrant > theta) & even).to(torch.int32)
               + ((quadrant > (pi / 2 - theta)) & ~even).to(torch.int32))
    prop = torch.full_like(direction, float("nan"))
    I1 = (section == 0) | (section == 1) | (section == 4) | (section == 5)
    prop = torch.where(I1 & (quadrant <= theta), quadrant / theta, prop)
    prop = torch.where(I1 & (quadrant > theta),
                       (quadrant - theta) / (pi / 2 - theta), prop)
    prop = torch.where(~I1 & (quadrant <= (pi / 2 - theta)),
                       quadrant / (pi / 2 - theta), prop)
    prop = torch.where(~I1 & (quadrant > (pi / 2 - theta)),
                       (quadrant - (pi / 2 - theta)) / theta, prop)
    section = torch.where(flats, FLAT, section)
    prop = torch.where(flats, float("nan"), prop)
    section = torch.where(section == 8, 0, section)
    adj = torch.tensor([a[1] for a in ANG_ADJ], dtype=direction.dtype,
                       device=direction.device)
    adjust = adj[torch.where(section < 0, section + 8, section).clamp(0, 7)
                 .long()]
    return section, (1 + adjust) / 2.0 - adjust * prop


def receiver_weights(section, proportion, elev):
    """(8, n, m): the share of each pixel's area sent to each neighbour;
    none to flats, out of the canvas, uphill, or at or under 1e-8."""
    W = [torch.zeros_like(elev) for _ in range(8)]
    for s in range(8):
        on = section == s
        for off, w in ((FACET_E1[s], proportion),
                       (FACET_E2[s], 1.0 - proportion)):
            k = OFFSET_INDEX[off]
            keep = on & (w > 1e-8) & (shift(elev, *off) <= elev)
            W[k] = W[k] + torch.where(keep, w, 0.0)
    return torch.stack(W)


def receivers(W):
    """``(recv, wt)``, (2, N) each: the flat indices of each pixel's (at
    most two) receivers, -1 for none, and the shares sent to them."""
    _, n, m = W.shape
    N = n * m
    dev = W.device
    wt, k = torch.topk(W.reshape(8, N), 2, dim=0)
    di = torch.tensor([o[0] for o in OFFSETS], device=dev)[k]
    dj = torch.tensor([o[1] for o in OFFSETS], device=dev)[k]
    ii = torch.arange(N, device=dev) // m
    jj = torch.arange(N, device=dev) % m
    return torch.where(wt > 0, (ii + di) * m + (jj + dj), -1), wt


def accumulate(recv, wt, base):
    """The area ``a = base + inflow(a)`` by a topological sweep (Kahn).
    Returns the area and the sweep's fronts in order (every pixel once,
    after all its donors).  Raises if the receiver graph has a cycle."""
    N = base.numel()
    indeg = torch.zeros(N, dtype=torch.int32, device=base.device)
    for s in range(2):
        r = recv[s][recv[s] >= 0]
        indeg.index_add_(0, r, torch.ones_like(r, dtype=torch.int32))
    area = base.reshape(-1).clone()
    front = torch.nonzero(indeg == 0).reshape(-1)
    fronts, done = [], 0
    while front.numel():
        fronts.append(front)
        done += front.numel()
        nxt = []
        for s in range(2):
            r = recv[s][front]
            keep = r >= 0
            src, r = front[keep], r[keep]
            area.index_add_(0, r, wt[s][src] * area[src])
            indeg.index_add_(0, r, torch.full_like(r, -1, dtype=torch.int32))
            nxt.append(r)
        cand = torch.unique(torch.cat(nxt))
        front = cand[indeg[cand] == 0]
    if done != N:
        raise RuntimeError("the receiver graph has a cycle through %d pixels"
                           % (N - done))
    return area.view(base.shape), fronts


def downstream(seeds, recv, fronts):
    """The pixels that ``seeds`` (bool, flat) or any pixel downstream of
    them sends area to, the seeds included."""
    out = seeds.clone()
    for front in fronts:
        hot = front[out[front]]
        for s in range(2):
            r = recv[s][hot]
            out[r[r >= 0]] = True
    return out


def terrain_step(elev, dX, dY, dX2, dY2, dtype=torch.float64):
    """``({mag, direction, flats, uca, twi}, graph)`` of one tile, computed
    in ``dtype`` on the device of ``elev`` (a tensor; NaN is nodata);
    ``twi`` is stored x10, as the program stores it.  ``graph`` is
    ``(recv, fronts)``, for :func:`downstream`."""
    elev = elev.to(dtype)
    dev = elev.device
    dX, dY, dX2, dY2 = (torch.as_tensor(np.asarray(a), device=dev).to(dtype)
                        for a in (dX, dY, dX2, dY2))
    mag, direction = slopes_directions(elev, dX, dY)
    flats = flats_extended(elev, mag)
    direction = torch.where(flats, FLAT, direction)
    mag = torch.where(flats, FLAT, mag)
    section, proportion = section_proportion(direction, flats, dX, dY)
    recv, wt = receivers(receiver_weights(section, proportion, elev))
    del section, proportion
    base = (dX2 * dY2)[:, None].expand(elev.shape)
    area, fronts = accumulate(recv, wt, base)
    del wt
    uca = torch.where(flats, float("nan"), area)
    twi = torch.log(uca / (mag + 1e-3)) * 10
    return (dict(mag=mag, direction=direction, flats=flats, uca=uca,
                 twi=twi), (recv, fronts))


class Planes(dict):
    """The reference's planes of a tile on the host, with
    :meth:`downstream` over the reference's own drainage graph and the
    area of the tile's smallest pixel, ``cell_area``."""

    def downstream(self, seeds):
        recv, fronts = self.graph
        flat = torch.from_numpy(np.ascontiguousarray(seeds).reshape(-1))
        return downstream(flat.to(recv.device), recv, fronts).cpu().numpy(
            ).reshape(seeds.shape)


def planes(tile, spacing, config, device, dtype=torch.float64):
    """The reference's :class:`Planes` of a host tile."""
    elev = torch.from_numpy(np.asarray(tile)).to(device)
    out, graph = terrain_step(elev, *spacing, dtype=dtype)
    p = Planes({k: v.float().cpu().numpy() if v.dtype == torch.bfloat16
                else v.cpu().numpy() for k, v in out.items()})
    p.graph = graph
    p.cell_area = float(np.min(np.asarray(spacing[2])
                               * np.asarray(spacing[3])))
    return p
