"""Elevation conditioning on the device: flat filling as label flood +
segment reductions + chamfer relaxation.

Port of ``pydem_tpu/core/flats_device.py`` (``fill_flats_device`` and the
quantization-pit raise).  The four phases are the same:

1. flat mask (3×3 min filter) and 8-connected components by min-index label
   flood (:func:`pydem_tpu_torch.core.slope_direction.label_flood`);
2. per-region scalars (drain existence, source min-elevation, centroid,
   border statistics) by segment reductions keyed on the region label;
3. source/drain seeding per pixel;
4. inverse-distance-squared interpolation with in-region chamfer distances
   (orth +1 / diag +√2), iterated min-relaxation.

Segment reductions are ``scatter_reduce_``/``index_add_`` into a table
prefilled with the reduction's identity (min: +inf, or an integer dtype's
max; max: -inf, or its min), which is what ``jax.ops.segment_min``/
``segment_max`` give an empty segment.  Segment sums of counts, row and
column indices and flags are integer sums in int64, cast to the float
dtype afterwards: exact, and on CUDA free of the order-dependent float
atomics a float sum would use.
The two chamfer ``while_loop`` phases are Python loops that read one host
flag per sweep.
"""
from __future__ import annotations

import torch

from .slope_direction import label_flood
from .stencil import NEIGHBOR_OFFSETS, shift

SQRT2 = 2.0 ** 0.5


def _flat_mask_no_corner_exclusion(elev, below_sea):
    mn = elev
    for di, dj in NEIGHBOR_OFFSETS:
        mn = torch.minimum(mn, shift(elev, di, dj, float("inf")))
    sea = (elev != 0) if below_sea else (elev > 0)
    return (mn >= elev) & sea


def _flat_mask(elev, below_sea):
    flat = _flat_mask_no_corner_exclusion(elev, below_sea)
    flat[0, 0] = flat[-1, 0] = flat[0, -1] = flat[-1, -1] = False
    return flat


def _edge_ring(shape, device):
    edge = torch.zeros(shape, dtype=torch.bool, device=device)
    edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
    return edge


def _seg(op, vals, ids, num):
    """Segment reduction of the flat ``vals`` keyed on ``ids`` into ``num``
    segments: ``"min"``/``"max"`` in ``vals``' dtype, ``"sum"`` in int64
    (for integer and boolean values only)."""
    if op == "sum":
        out = torch.zeros(num, dtype=torch.int64, device=vals.device)
        return out.index_add_(0, ids, vals.to(torch.int64))
    if vals.dtype.is_floating_point:
        fill = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        fill = info.max if op == "min" else info.min
    out = torch.full((num,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, reduce="a" + op)


def fill_flats_device(elev, source_tol=1, fill_peaks=True, fill_pits=True,
                      below_sea=False, maximum_pit_area=32):
    """Fill/interpolate flats on the device of ``elev``.  Returns the
    conditioned canvas."""
    n, m = elev.shape
    N = n * m
    dev, fdt = elev.device, elev.dtype
    if maximum_pit_area:
        elev = _fill_pit_artifacts(elev, below_sea, maximum_pit_area)

    data = elev
    flat = _flat_mask(data, below_sea)
    lbl, rep = label_flood(flat, data)
    ids = torch.where(flat, lbl, N).reshape(-1).long()

    def seg(op, vals):
        return _seg(op, vals.reshape(-1), ids, N + 1)

    def per_px(table):  # a segment table broadcast back to the pixels
        return table[ids].reshape(n, m)

    # per-region border statistics, inside out: each region pixel r looks
    # at its non-flat neighbours b (drain: b == rep; source: b > rep), then
    # one segment reduction keyed on r's own label
    INF = float("inf")
    drain_local = torch.zeros((n, m), dtype=torch.bool, device=dev)
    src_local = torch.full((n, m), INF, dtype=fdt, device=dev)
    for di, dj in NEIGHBOR_OFFSETS:
        b_e = shift(data, di, dj, float("nan"))
        nb = ~shift(flat, di, dj, False)
        drain_local = drain_local | (nb & (b_e == rep))
        src_local = torch.minimum(src_local,
                                  torch.where(nb & (b_e > rep), b_e, INF))

    ii = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, m)
    jj = torch.arange(m, dtype=torch.int32, device=dev)[None, :].expand(n, m)
    edge = _edge_ring((n, m), dev)

    esrc_of = per_px(seg("min", torch.where(flat, src_local, INF)))
    has_drain = per_px(seg("sum", flat & drain_local)) > 0
    count_of = per_px(seg("sum", flat)).to(fdt)
    si_of = per_px(seg("sum", torch.where(flat, ii, 0))).to(fdt)
    sj_of = per_px(seg("sum", torch.where(flat, jj, 0))).to(fdt)
    edge_cnt_of = per_px(seg("sum", flat & edge)).to(fdt)
    has_src = torch.isfinite(esrc_of)
    e_region = rep

    # single-pixel regions in <=3x3 windows
    nbr_higher = torch.zeros((n, m), dtype=torch.int32, device=dev)
    nbr_total = torch.zeros((n, m), dtype=torch.int32, device=dev)
    min_higher = torch.full((n, m), INF, dtype=fdt, device=dev)
    ones = torch.ones((n, m), dtype=torch.bool, device=dev)
    for di, dj in NEIGHBOR_OFFSETS:
        nbr_total = nbr_total + shift(ones, di, dj, False).int()
        nbr_higher = nbr_higher + (shift(data, di, dj, float("nan"))
                                   > data).int()
        qe = shift(data, di, dj, INF)
        min_higher = torch.minimum(min_higher,
                                   torch.where(qe > data, qe, INF))
    single = flat & (count_of == 1)
    sp_pit = single & (nbr_higher == nbr_total)
    sp_fill = single & ~sp_pit & (nbr_higher > 0)
    sp_peak = single & ~sp_pit & (nbr_higher == 0) & bool(fill_peaks)
    out = torch.where(sp_fill,
                      data + torch.clamp(min_higher - data, max=1.0) - 0.01,
                      data)
    out = torch.where(sp_peak, data + 0.5, out)

    # multi-pixel regions
    multi = flat & (count_of > 1)
    eH = torch.minimum(e_region + 1.0, esrc_of)       # normal sources
    eH = torch.where(has_src, eH, e_region + 0.5)     # peak fallback

    # centroid: nearest in-region pixel to the centre of mass, scan-order ties
    com_i = si_of / torch.clamp(count_of, min=1)
    com_j = sj_of / torch.clamp(count_of, min=1)
    ci, cj = ii - com_i, jj - com_j
    dist2 = ci * ci + cj * cj
    dmin = per_px(seg("min", torch.where(flat, dist2, INF)))
    at_min = flat & (dist2 == dmin)
    idx = torch.arange(N, dtype=torch.int32, device=dev).reshape(n, m)
    cent = per_px(seg("min", torch.where(at_min, idx, N)))
    is_centroid = flat & (idx == cent)

    touches_of = edge_cnt_of > 0
    use_edge_drain = ~has_drain & touches_of
    use_pit_drain = ~has_drain & ~touches_of & bool(fill_pits)
    edge_drain_ok = (count_of - edge_cnt_of) > 0

    peak_region = multi & ~has_src & bool(fill_peaks)
    out = torch.where(peak_region & is_centroid, eH, out)

    replace = ((peak_region & is_centroid)
               | (multi & use_edge_drain & edge & edge_drain_ok)
               | (multi & use_pit_drain & is_centroid & has_src)
               | (multi & use_pit_drain & ~has_src & bool(fill_peaks)
                  & is_centroid))
    active_src = has_src | bool(fill_peaks)
    active_drain = has_drain | (use_edge_drain & edge_drain_ok) | use_pit_drain
    active = multi & active_src & active_drain

    def src_seed_out(q_e, q_flat):
        return (flat & has_src & ~q_flat & (q_e > e_region)
                & (q_e <= esrc_of + source_tol))

    def drain_seed_out(q_e, q_flat):
        return flat & has_drain & ~q_flat & (q_e == e_region)

    src_in = peak_region & is_centroid
    drain_in = ((multi & use_edge_drain & edge & edge_drain_ok)
                | (multi & use_pit_drain & is_centroid))
    dH, dL = _chamfer_pair(data, flat, ids, (src_seed_out, src_in),
                           (drain_seed_out, drain_in))

    interp = active & ~replace
    dL2, dH2 = dL * dL, dH * dH
    return torch.where(interp, (eH * dL2 + e_region * dH2) / (dL2 + dH2), out)


def _chamfer_pair(data, flat, ids, seed_a, seed_b):
    """In-region chamfer distances from two seed sets, replicating the
    reference's ``get_distance`` early stop: each region keeps the values of
    the sweep at which its last pixel was first reached.

    ``seed_x = (out_pred, in_mask)``: ``out_pred(q_elev, q_flat)`` marks
    out-of-region seeds adjacent to region pixels (evaluated per neighbour
    offset), ``in_mask`` the in-region zero-distance seeds.  Both distances
    relax in the same loops (extra sweeps past a fixed point are no-ops).
    """
    n, m = data.shape
    N = n * m
    big = float(N)
    steps = [1.0 if di * dj == 0 else SQRT2 for di, dj in NEIGHBOR_OFFSETS]

    def adj_of(out_pred):  # static out-of-region seed adjacency
        adj = torch.full((n, m), float("inf"), dtype=data.dtype,
                         device=data.device)
        for (di, dj), step in zip(NEIGHBOR_OFFSETS, steps):
            is_seed = out_pred(shift(data, di, dj, float("nan")),
                               shift(flat, di, dj, False))
            adj = torch.where(is_seed, torch.clamp(adj, max=step), adj)
        return torch.clamp(adj, max=big)

    seeds = [(seed_in, adj_of(out_pred)) for out_pred, seed_in in (seed_a,
                                                                   seed_b)]

    def relax(d, seed_in, adj):
        dn = d
        for (di, dj), step in zip(NEIGHBOR_OFFSETS, steps):
            dn = torch.minimum(dn, shift(d, di, dj, big) + step)
        dn = torch.where(flat, torch.minimum(dn, adj), big)
        return torch.where(seed_in, 0.0, dn)

    def sweep_all(ds):
        """One relaxation of both distances; whether either changed (one
        host read)."""
        new = [relax(d, s, a) for d, (s, a) in zip(ds, seeds)]
        changed = torch.stack([(a != b).any() for a, b in zip(new, ds)]).any()
        return new, bool(changed)

    d0 = [torch.where(s, 0.0, torch.full_like(data, big)) for s, _a in seeds]

    # phase A: the sweep at which each region pixel is first reached
    ds = d0
    arrival = [torch.where(d < big, 0, -1).int() for d in d0]
    sweep, changed = 0, True
    while changed:
        ds, changed = sweep_all(ds)
        arrival = [torch.where((d < big) & (a < 0), sweep + 1, a)
                   for d, a in zip(ds, arrival)]
        sweep += 1

    # freeze sweep per region per distance = its last arrival
    T = [_seg("max", torch.where(flat, a, -1).reshape(-1), ids, N + 1)[ids]
         .reshape(n, m) for a in arrival]

    # phase B: rerun, capturing each pixel's value at its region's freeze
    # sweep; seedless regions (T < 0) keep the converged values
    ds = d0
    outs = [torch.where(s, 0.0, torch.where(flat & (t <= 0), d,
                                            torch.full_like(d, big)))
            for d, (s, _a), t in zip(d0, seeds, T)]
    sweep, changed = 0, True
    while changed:
        ds, changed = sweep_all(ds)
        outs = [torch.where(flat & (t == sweep + 1), d, o)
                for d, o, t in zip(ds, outs, T)]
        sweep += 1
    return [torch.where(flat & (t < 0), d, o) for d, o, t in zip(ds, outs, T)]


def _fill_pit_artifacts(elev, below_sea, maximum_pit_area):
    """Quantization-pit raise: a flat region whose whole in-grid border sits
    exactly one unit higher, that does not touch the grid edge and has at
    most ``maximum_pit_area`` pixels, rises by one unit."""
    n, m = elev.shape
    N = n * m
    flat = _flat_mask_no_corner_exclusion(elev, below_sea)
    lbl, rep = label_flood(flat, elev)
    ids = torch.where(flat, lbl, N).reshape(-1).long()

    # at region pixel r, a non-flat in-grid neighbour b is 'bad' unless
    # b == rep + 1
    bad_local = torch.zeros((n, m), dtype=torch.bool, device=elev.device)
    ones = torch.ones((n, m), dtype=torch.bool, device=elev.device)
    for di, dj in NEIGHBOR_OFFSETS:
        b_e = shift(elev, di, dj, float("nan"))
        nb = ~shift(flat, di, dj, False) & shift(ones, di, dj, False)
        bad_local = bad_local | (nb & ~(b_e - 1 == rep))
    edge = _edge_ring((n, m), elev.device)

    def seg(op, vals):
        return _seg(op, vals.reshape(-1), ids, N + 1)

    cnt = seg("sum", flat)
    edge_any = seg("max", (flat & edge).int())
    bad_any = seg("max", (flat & bad_local).int())
    raise_region = ((bad_any == 0) & (edge_any == 0)
                    & (cnt <= maximum_pit_area) & (cnt > 0))
    inc = raise_region[ids].reshape(n, m) & flat
    return elev + inc.to(elev.dtype)
