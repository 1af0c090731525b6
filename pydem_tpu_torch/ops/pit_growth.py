"""Device-parallel pit drainage search: all pits grow at once, each in its
own window.

Port of ``pydem_tpu/ops/pit_growth.py``: ``grow_pits``, the dense link
extraction, ``pit_links_device_packed`` (the device chain's), and
``pit_links_device`` / ``connectivity_pits_device`` (host arrays out: the
``pit_backend="device"`` choice of the host-state ``calc_uca``).  Every pit
grows a region by its minimum-elevation border until it finds strictly
lower drain pixels, inside a window of side ``W`` centred on it (clipped to
the canvas).  The JAX version ``vmap``s one pit's search; here the pits are
the leading dimension of ``(P, W, W)`` tensors cut out of the canvas by
index arithmetic, and the per-pit ``while_loop`` is one lockstep loop over
all of them (the step is an exact no-op for a finished pit), with one host
read per two steps.

Differences from the JAX version, by design:
- no power-of-two padding of pit batches or link arrays: those kept XLA's
  compile keys stable, and eager PyTorch compiles nothing.  Pits still run
  in batches of at most :data:`PIT_BATCH`, which bounds memory;
- each batch's dense ``(PB, W, W)`` link planes are compacted to link
  triples as soon as the batch is grown, so only one batch's planes are
  live at a time;
- the link arrays hold exactly the links (no zero-weight padding), and
  drained-pit arrays hold one entry per pit;
- ``pit_links_device`` uses the same dense extraction as the packed search.
  The JAX version cuts each pit's drains to a fixed ``link_capacity`` (a
  static shape for XLA) and assembles the pits that overflow it on the host;
  the dense extraction has no capacity, so there is no overflow path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.stencil import dilate, sqrt_rn

# pits grown per call: the (PIT_BATCH, W, W) planes of one call are the
# search's peak memory (W = 96, float32: 75 MB per plane)
PIT_BATCH = 2048


def _windows(a, oi, oj, W):
    """``(P, W, W)`` windows of the 2-D ``a`` with top-left corners
    ``(oi, oj)`` (a gather; the windows lie inside ``a``)."""
    r = torch.arange(W, device=a.device)
    return a[(oi[:, None] + r)[:, :, None], (oj[:, None] + r)[:, None, :]]


def _lanes(v):
    """(P,) per-pit values broadcast against (P, W, W) planes."""
    return v[:, None, None]


def grow_pits(elev, pits_bool, pit_i, pit_j, W=96, max_iter=300,
              min_border=False):
    """Drainage search for all pits at once.

    ``elev``, ``pits_bool``: (n, m) canvas tensors; ``pit_i``/``pit_j``:
    (P,) int64 pit coordinates; ``W`` <= n, m.  Returns ``(origin_i,
    origin_j, drain (P, W, W), found (P,), clipped (P,))``.

    ``clipped`` marks pits whose grown region touched a window edge that is
    not a canvas edge: only those can differ from a search in a larger
    window.
    """
    n, m = elev.shape
    half = W // 2
    oi = torch.clamp(pit_i - half, 0, max(n - W, 0))
    oj = torch.clamp(pit_j - half, 0, max(m - W, 0))
    e = _windows(elev, oi, oj, W)
    pits_w = _windows(pits_bool, oi, oj, W)
    P = pit_i.numel()
    lane = torch.arange(P, device=elev.device)
    li, lj = pit_i - oi, pit_j - oj
    R = torch.zeros((P, W, W), dtype=torch.bool, device=elev.device)
    R[lane, li, lj] = True
    epit = e[lane, li, lj]
    inf = float("inf")
    if min_border:
        epit_border = torch.where(dilate(R) & ~R, e, inf).amin(dim=(1, 2))
    else:
        epit_border = epit

    drain = torch.zeros_like(R)
    found = torch.zeros(P, dtype=torch.bool, device=elev.device)
    it = torch.zeros(P, dtype=torch.int32, device=elev.device)

    def step(R, drain, found, it):
        # `live` gates every state change, so the step is an exact no-op
        # for a pit that has drained, stalled or reached max_iter
        live = ~found & (it < max_iter)
        border = dilate(R) & ~R
        emin = torch.where(border, e, inf).amin(dim=(1, 2))
        nb = border & ~pits_w
        pb = border & pits_w
        nb_min = torch.where(nb, e, inf).amin(dim=(1, 2))
        pb_min = torch.where(pb, e, inf).amin(dim=(1, 2))
        take_nb = nb_min < epit_border
        take_pb = ~take_nb & (pb_min < epit)
        new_drain = torch.where(
            _lanes(take_nb), nb & (e < _lanes(epit_border)),
            _lanes(take_pb) & pb & (e < _lanes(epit)))
        done_now = (take_nb | take_pb) & live
        grow = border & (e == _lanes(emin))
        R_next = torch.where(_lanes(done_now | ~live), R, R | grow)
        # stall (no growth, no drain) ends the search undrained
        stalled = live & ~done_now & ~grow.any(dim=(1, 2))
        return (R_next, torch.where(_lanes(done_now), new_drain, drain),
                found | done_now,
                torch.where(stalled, max_iter, it + live.int()))

    # two steps per host read, as the JAX loop checks its condition
    while bool((~found & (it < max_iter)).any()):
        R, drain, found, it = step(*step(R, drain, found, it))

    clipped = ((R[:, 0, :].any(1) & (oi > 0))
               | (R[:, -1, :].any(1) & (oi + W < n))
               | (R[:, :, 0].any(1) & (oj > 0))
               | (R[:, :, -1].any(1) & (oj + W < m)))
    return oi, oj, drain, found, clipped


def _grow_extract_dense(elev, pits_bool, pit_i, pit_j, cdX, cdY, dX,
                        max_dist_xy, W=96, max_iter=300, min_border=False,
                        max_dist=32, has_xy=False):
    """Grow the pits and compute their drain-link quantities densely on the
    (P, W, W) windows: the distance and weight arithmetic of the reference's
    connectivity_pits (dem_processing.py:1337-1357, 1993-1997) at every
    window cell, masked by the drain set.  Returns ``(dst_flat (P, W, W),
    wgt (P, W, W), valid (P, W, W), mean_s (P,), ok (P,), clipped (P,))``.
    """
    n, m = elev.shape
    oi, oj, drain, found, clipped = grow_pits(elev, pits_bool, pit_i, pit_j,
                                              W=W, max_iter=max_iter,
                                              min_border=min_border)
    fdt = elev.dtype
    wi = torch.arange(W, device=elev.device)
    Id = _lanes(oi) + wi[None, :, None]
    Jd = _lanes(oj) + wi[None, None, :]
    e_win = _windows(elev, oi, oj, W)
    epit = _lanes(elev[pit_i, pit_j])
    pi3, pj3 = _lanes(pit_i), _lanes(pit_j)

    valid = drain & _lanes(found)
    if max_dist:
        di, dj = pi3 - Id, pj3 - Jd
        valid &= di * di + dj * dj <= max_dist * max_dist
    a = torch.minimum(pi3, Id)
    b = torch.maximum(pi3, Id)
    dx = torch.where(a == b, dX[torch.clamp(pi3, max=n - 2)],
                     (cdX[b] - cdX[a]) / torch.clamp(b - a, min=1).to(fdt))
    dx = dx * (pj3 - Jd).to(fdt)
    dy = cdY[b] - cdY[a]
    dxy = sqrt_rn(dx * dx + dy * dy)
    if has_xy:
        valid &= dxy <= max_dist_xy
    s = torch.abs(epit - e_win) / torch.where(dxy > 0, dxy, 1.0)
    s = torch.where(valid, s, 0.0)
    ssum = s.sum(dim=(1, 2))
    cnt = valid.sum(dim=(1, 2))
    ok = found & (cnt > 0)
    wgt = s / _lanes(torch.where(ssum > 0, ssum, 1.0))
    mean_s = ssum / torch.clamp(cnt, min=1).to(fdt)
    return Id * m + Jd, wgt, valid, mean_s, ok, clipped


def _compact_dense(take, wgt, dst_flat, src_b):
    """The (pit, drain) pairs marked in the (P, W, W) ``take`` as link
    triples ``(src, dst, wgt)``, in lane-major order."""
    idx = torch.nonzero(take.reshape(-1)).squeeze(1)
    lane = idx // (take.shape[1] * take.shape[2])
    return src_b[lane], dst_flat.reshape(-1)[idx], wgt.reshape(-1)[idx]


def _grow_dense_batches(elev, pits_bool, pit_i, pit_j, consts, W, keep_clipped,
                        prune=True, **kw):
    """Grow the pits in batches of at most :data:`PIT_BATCH` and compact each
    batch's links as soon as it is grown.

    A lane's links are taken when it drained (and, unless ``keep_clipped``,
    did not touch an inner window edge), pruned to weights > 1e-8 (the
    reference's adjacency pruning, dem_processing.py:1136) unless ``prune``
    is False.  Returns
    ``(src, dst, wgt, mean_s, ok, clipped)``: the links, then per lane.
    """
    m = elev.shape[1]
    parts = []
    for p0 in range(0, pit_i.numel(), PIT_BATCH):
        pi, pj = pit_i[p0: p0 + PIT_BATCH], pit_j[p0: p0 + PIT_BATCH]
        dst, wgt, valid, mean_s, ok, clipped = _grow_extract_dense(
            elev, pits_bool, pi, pj, *consts, W=W, **kw)
        drained = ok if keep_clipped else ok & ~clipped
        take = _lanes(drained) & valid
        if prune:
            take = take & (wgt > 1e-8)
        parts.append(_compact_dense(take, wgt, dst, pi * m + pj)
                     + (mean_s, ok, clipped))
    return tuple(torch.cat(c) for c in zip(*parts))


def _pit_coords(pits_bool):
    """Pit (i, j) coordinates in scan order (int64)."""
    idx = torch.nonzero(pits_bool.reshape(-1)).squeeze(1)
    m = pits_bool.shape[1]
    return idx // m, idx % m


def pit_links_device_packed(flats_d, elev_d, dX, dY, max_iter=300,
                            max_dist=32, max_dist_XY=None, min_border=False,
                            window=96, first_window=64):
    """Pit links for the device chain, on the device of ``elev_d``.

    Two-tier windows: every pit first grows inside a ``first_window``
    window; pits whose region touched an inner window edge (the exact
    condition under which a small window can differ from a large one, see
    :func:`grow_pits`) are grown again at ``window``.

    Returns None when the canvas has no pits, else a dict:

    - ``src, dst, wgt``: the link triples (flat indices, weights);
    - ``drained_idx``: (P,) flat index of each drained pit, and the
      out-of-bounds sentinel n*m for a pit that did not drain: consumers
      must mask the sentinel out before scattering;
    - ``drained_mag``: (P,) the drained pits' new slope magnitudes;
    - ``n_warn``: pits with nowhere to drain; ``n_links``: the link count.
    """
    n, m = elev_d.shape
    pits_bool = flats_d & (elev_d > 0)
    pit_i, pit_j = _pit_coords(pits_bool)
    if pit_i.numel() == 0:
        return None

    dX = np.asarray(dX, "float64")
    dY = np.asarray(dY, "float64")
    W2 = int(min(window, n, m))
    W1 = int(min(first_window, W2))
    fdt, dev = elev_d.dtype, elev_d.device
    consts = tuple(torch.as_tensor(c, dtype=fdt, device=dev) for c in (
        np.concatenate([[0.0], np.cumsum(dX)]),
        np.concatenate([[0.0], np.cumsum(dY)]), dX))
    kw = dict(max_dist_xy=float(max_dist_XY or 0.0), max_iter=max_iter,
              min_border=min_border, max_dist=max_dist,
              has_xy=bool(max_dist_XY))

    src, dst, wgt, mean_s, ok, clipped = _grow_dense_batches(
        elev_d, pits_bool, pit_i, pit_j, consts, W1, keep_clipped=False, **kw)
    drained = ok & ~clipped
    n_warn, n_retry = (int(v) for v in torch.stack(
        [(~ok & ~clipped).sum(), clipped.sum()]).tolist())

    if n_retry:
        # tier 2: regrow the clipped pits at the full window; their tier-1
        # links were not taken
        lanes2 = torch.nonzero(clipped).squeeze(1)
        src2, dst2, wgt2, mean2, ok2, _cl2 = _grow_dense_batches(
            elev_d, pits_bool, pit_i[lanes2], pit_j[lanes2], consts, W2,
            keep_clipped=True, **kw)
        n_warn += int((~ok2).sum())
        src, dst, wgt = (torch.cat(p) for p in ((src, src2), (dst, dst2),
                                                 (wgt, wgt2)))
        drained[lanes2] = ok2
        mean_s[lanes2] = torch.where(ok2, mean2, mean_s[lanes2])

    drained_idx = torch.where(drained, pit_i * m + pit_j, n * m)
    return {"src": src, "dst": dst, "wgt": wgt, "drained_idx": drained_idx,
            "drained_mag": mean_s.to(fdt), "n_warn": n_warn,
            "n_links": src.numel()}


def pit_links_device(flats_d, elev_d, dX, dY, max_iter=300, max_dist=32,
                     max_dist_XY=None, min_border=False, window=96):
    """Pit-link search on the device of ``elev_d``, host arrays out.

    One tier at ``window`` (no retry), no weight pruning: the caller prunes,
    as it does for the host search.  There is no ``link_capacity`` (see the
    module docstring).

    Returns numpy ``(src, dst, wgt, drained_src_flat, drained_mean_s)``:
    the link triples in pit scan order, row-major within a pit, plus the
    flat indices of the pits that drained and their new slope magnitudes
    (the caller clears ``flats`` and sets ``mag`` there).  Warns, as the host
    search does, when pits found no drain.
    """
    import warnings

    n, m = elev_d.shape
    pits_bool = flats_d & (elev_d > 0)
    pit_i, pit_j = _pit_coords(pits_bool)
    z64 = np.zeros(0, "int64")
    if pit_i.numel() == 0:
        return z64, z64, np.zeros(0, "float64"), z64, np.zeros(0, "float64")

    dX = np.asarray(dX, "float64")
    dY = np.asarray(dY, "float64")
    fdt, dev = elev_d.dtype, elev_d.device
    consts = tuple(torch.as_tensor(c, dtype=fdt, device=dev) for c in (
        np.concatenate([[0.0], np.cumsum(dX)]),
        np.concatenate([[0.0], np.cumsum(dY)]), dX))
    src, dst, wgt, mean_s, ok, _clipped = _grow_dense_batches(
        elev_d, pits_bool, pit_i, pit_j, consts, int(min(window, n, m)),
        keep_clipped=True, prune=False,
        max_dist_xy=float(max_dist_XY or 0.0), max_iter=max_iter,
        min_border=min_border, max_dist=max_dist, has_xy=bool(max_dist_XY))
    n_warn = int((~ok).sum())
    if n_warn:
        warnings.warn("%d pits had no place to drain to in this chunk"
                      % n_warn)
    drained_src = (pit_i * m + pit_j)[ok]
    return (src.cpu().numpy().astype("int64"),
            dst.cpu().numpy().astype("int64"),
            wgt.cpu().numpy().astype("float64"),
            drained_src.cpu().numpy().astype("int64"),
            mean_s[ok].cpu().numpy().astype("float64"))


def connectivity_pits_device(flats, elev, mag, dX, dY, max_iter=300,
                             max_dist=32, max_dist_XY=None, min_border=False,
                             window=96, device="cuda"):
    """Drop-in replacement for ``conditioning.connectivity_pits`` with the
    growth loops and the link assembly on ``device`` (the GPU unless the
    CPU is asked for, as the JAX function runs on the default backend), in
    its default float dtype.  Same return signature (host arrays; the
    flats/mag updates are applied here)."""
    from .. import default_dtype

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connectivity_pits_device(device=%r): torch.cuda "
                           "is not available" % (device,))
    flats = np.asarray(flats).copy()
    mag = np.asarray(mag).copy()
    src, dst, wgt, drained_src, drained_mean = pit_links_device(
        torch.as_tensor(flats, device=device),
        torch.as_tensor(np.asarray(elev), dtype=default_dtype(device),
                        device=device),
        dX, dY, max_iter=max_iter, max_dist=max_dist,
        max_dist_XY=max_dist_XY, min_border=min_border, window=window)
    mag.ravel()[drained_src] = drained_mean
    flats.ravel()[drained_src] = False
    return src, dst, wgt, flats, mag
