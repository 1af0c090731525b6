"""Elevation conditioning: flat filling, pit-artifact filling, pit draining.

Host-side (numpy/scipy) code with the reference pyDEM's exact semantics: a
copy of ``pydem_tpu/core/conditioning.py`` of the JAX package, the body
unchanged below this docstring but for ``drain_pit_paths``'s call into this
package's own native module (:mod:`pydem_tpu_torch.native`).

- :func:`fill_pit_artifacts`       — dem_processing.py:396-426
- :func:`fill_flats`               — dem_processing.py:305-394, 551-579
- :func:`drain_pit_paths`          — dem_processing.py:428-548
- :func:`connectivity_pits`        — dem_processing.py:1269-1382
- :func:`connectivity_pits_spill`  — dem_processing.py:1384-1508 (deprecated mode)
- :func:`connectivity_flats`       — dem_processing.py:1510-1645 (deprecated mode)

These are the ``conditioning_backend="host"`` and ``pit_backend="host"``
paths of :class:`~pydem_tpu_torch.api.DEMProcessor` (the defaults, as in the
JAX package); the device chain uses only ``drain_pit_paths``: it downloads
the elevation, carves it here (with the C++ kernel, or the numpy loop below,
its plain twin) and uploads only the carved pixels.

Notable reference behaviors reproduced deliberately:

- ``_fill_flat``'s recursive refinement writes into a *copy* that is then
  discarded (``dem_processing.py:389-394`` — ``out = out2`` rebinds a local
  just before returning), so recursion has no observable effect; only the
  first-level interpolation lands.  We therefore run level-0 only.
- Pit-path carving mutates elevation *during* the ascending-elevation pit
  loop, so later pits see earlier carvings (dem_processing.py:450-539).
- ``connectivity_pits`` computes the pit set once and never re-reads mutated
  state across pits, so it is order-independent (and parallelizable).
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy import ndimage as ndi

STRUCT8 = np.ones((3, 3), bool)
SQRT2 = np.sqrt(2.0)
_ORTH = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


# ---------------------------------------------------------------------------
# small region helpers (semantics of utils.py:270-468)
# ---------------------------------------------------------------------------

def _adjacent_flat_indices(I, shape):
    """Flattened indices 8-adjacent to the index set I (utils.py:270-311)."""
    m, n = shape
    In = I % n
    bL = In != 0
    bR = In != n - 1
    J = np.concatenate([
        I - n, I[bL] - 1, I[bR] + 1, I + n,
        I[bL] - n - 1, I[bR] - n + 1, I[bL] + n - 1, I[bR] + n + 1,
    ])
    return J[(J >= 0) & (J < m * n)]


def _border_flat_indices(I, shape):
    """Adjacent minus the set itself, sorted ascending (utils.py:313-340)."""
    return np.setdiff1d(_adjacent_flat_indices(I, shape), I)


def _border_mask(region):
    interior = region[1:-1, 1:-1]
    if interior.all() and interior.any():
        return ~region
    grown = ndi.maximum_filter(region, footprint=STRUCT8)
    return grown & ~region


def _region_distance(region, src):
    """Within-region chamfer distance from src pixels (utils.py:374-402)."""
    dmax = float(region.size)
    d = np.full(region.shape, dmax)
    d[src] = 0
    for _ in range(region.size):
        d_orth = ndi.minimum_filter(d, footprint=_ORTH) + 1
        d_diag = ndi.minimum_filter(d, (3, 3)) + SQRT2
        d_adj = np.minimum(d_orth[region], d_diag[region])
        d[region] = np.minimum(d_adj, d[region])
        if (d[region] < dmax).all():
            break
    return d


def _centroid(region):
    """In-region pixel nearest the center of mass (utils.py:450-468)."""
    x, y = ndi.center_of_mass(region)
    w = np.argwhere(region)
    i, j = w[np.argmin(np.linalg.norm(w - (x, y), axis=1))]
    return i, j


def _grow_window(obj, shape):
    """bbox slices grown by 1, clipped (utils.py:410-447)."""
    return (
        slice(max(0, obj[0].start - 1), min(shape[0], obj[0].stop + 1)),
        slice(max(0, obj[1].start - 1), min(shape[1], obj[1].stop + 1)),
    )


def _ordered_slice(a, b):
    return slice(a, b) if a < b else slice(b, a)


def _fence_mean(dX, i1, i2):
    """Mean fence spacing between rows i1 and i2 (dem_processing.py:1993-1997)."""
    if i1 == i2:
        return dX[min(i1, dX.size - 1)]
    return dX[_ordered_slice(i1, i2)].mean()


def _sea_mask(elev, below_sea):
    return (elev != 0) if below_sea else (elev > 0)


# ---------------------------------------------------------------------------
# pit-artifact filling (dem_processing.py:396-426)
# ---------------------------------------------------------------------------

def fill_pit_artifacts(elev, maximum_pit_area=32, below_sea=False):
    """Raise quantization pits (flat region whose entire border sits exactly
    +1 above) by one elevation unit.  Returns a new array."""
    out = elev.copy()
    flat = (ndi.minimum_filter(elev, (3, 3)) >= elev) & _sea_mask(elev, below_sea)
    labels, _n = ndi.label(flat, structure=STRUCT8)
    for i, bbox in enumerate(ndi.find_objects(labels)):
        win = _grow_window(bbox, elev.shape)
        # regions whose bbox touches the array edge are skipped (:414-415)
        if not (elev[win].shape[0] == elev[bbox].shape[0] + 2
                and elev[win].shape[1] == elev[bbox].shape[1] + 2):
            continue
        mask = labels[win] == i + 1
        ring = ndi.maximum_filter(mask, (3, 3)) ^ mask
        region_elev = elev[win][mask][0]
        if np.all(elev[win][ring] - 1 == region_elev) and mask.sum() <= maximum_pit_area:
            out[win] += 1 * mask
    return out


# ---------------------------------------------------------------------------
# flat filling (dem_processing.py:305-394, 551-579)
# ---------------------------------------------------------------------------

def _interpolate_flat(roi, out, region, edge, source_tol=1, fill_peaks=True,
                      fill_pits=True):
    """Fill one flat region by inverse-distance-squared interpolation between
    its high (source) and low (drain) border.  Writes region pixels of
    ``out`` in place."""
    e = roi[region][0]

    # single-pixel region inside a <=3x3 window (:311-325)
    if roi.size <= 9 and region.sum() == 1:
        higher = roi > e
        n = higher.sum()
        if n == roi.size - 1:
            pass  # pit: leave
        elif n > 0:
            out[region] += min(1.0, roi[higher].min() - e) - 0.01
        elif fill_peaks:
            out[region] += 0.5
        return

    border = _border_mask(region)
    drain = border & (roi == e)
    source = border & (roi > e)
    replace = None

    if source.any():
        e_source = roi[source].min()
        eH = min(e + 1.0, e_source)
        source &= roi <= e_source + source_tol
    elif fill_peaks:
        eH = e + 0.5
        c = _centroid(region)
        out[c] = eH
        source[c] = True
        replace = source
    else:
        return

    if drain.any():
        pass
    elif (region & edge).any():
        replace = drain = region & edge
        if not (region & ~drain).any():
            return
    elif fill_pits:
        c = _centroid(region)
        drain[c] = True
        replace = drain
    else:
        return

    dH = _region_distance(region, source)
    dL = _region_distance(region, drain)
    interp = region if replace is None else region & ~replace
    out[interp] = (eH * dL[interp] ** 2 + e * dH[interp] ** 2) / (
        dL[interp] ** 2 + dH[interp] ** 2)


def fill_flats(elev, source_tol=1, fill_peaks=True, fill_pits=True,
               below_sea=False, maximum_pit_area=32):
    """Condition elevation by filling/interpolating flats.  Returns a new
    float64 array (NaN for masked input pixels)."""
    if maximum_pit_area:
        elev = fill_pit_artifacts(elev, maximum_pit_area, below_sea)

    data = np.ma.filled(np.ma.asarray(elev).astype("float64"), np.nan)
    filled = data.copy()
    edge = np.ones_like(data, bool)
    edge[1:-1, 1:-1] = False
    flat = (ndi.minimum_filter(data, (3, 3)) >= data) & _sea_mask(data, below_sea)
    for corner in ((0, 0), (-1, 0), (0, -1), (-1, -1)):
        flat[corner] = False
    labels, _n = ndi.label(flat, structure=STRUCT8)
    for i, bbox in enumerate(ndi.find_objects(labels)):
        win = _grow_window(bbox, data.shape)
        _interpolate_flat(data[win], filled[win], labels[win] == i + 1,
                          edge[win], source_tol, fill_peaks, fill_pits)
    return filled


# ---------------------------------------------------------------------------
# pit drain paths (dem_processing.py:428-548)
# ---------------------------------------------------------------------------

def drain_pit_paths(elev, dX, dY, max_iter=300, max_dist=32, max_dist_XY=None,
                    below_sea=False, native=None):
    """Carve a monotone elevation ramp from each pit to the nearest lower
    drain along a min-elevation growth path.  Returns a new array.

    ``native=None`` (default) uses the C++ kernel when it builds, and the
    numpy loop otherwise; True forces native (raises ``RuntimeError`` if g++
    fails), False forces numpy.  Both produce identical output.
    """
    elev = np.array(elev, "float64", order="C")  # fresh copy; carved in place
    e = elev.ravel()
    shape = elev.shape
    sea = _sea_mask(e, below_sea)

    ring = np.ones((3, 3), bool)
    ring[1, 1] = False
    pits_bool = (ndi.minimum_filter(elev, footprint=ring).ravel() > e) & sea
    pits = np.where(pits_bool)[0]
    pits_sorted = pits[np.argsort(e[pits])]

    if native is None or native:
        from ..native import drain_pit_paths_native

        warn = drain_pit_paths_native(elev, dX, dY, pits_sorted, max_iter,
                                      max_dist, max_dist_XY,
                                      required=bool(native))
        if warn is not None:
            if warn:
                warnings.warn("%d pits had no place to drain to in this chunk"
                              % warn)
            return elev

    warn_pits = []
    for pit in pits_sorted:
        area = np.array([pit], "int64")
        drain = None
        epit = e[pit]
        path = [pit]
        for _ in range(max_iter):
            border = _border_flat_indices(area, shape)
            if border.size == 0:
                break
            eb = e[border]
            emin = eb.min()
            if emin < epit:
                drain = border[eb == emin]
                break
            grow = border[eb == emin]
            path += grow.tolist()
            area = np.concatenate([area, grow])

        if drain is None:
            warn_pits.append(pit)
            continue

        ipit, jpit = np.unravel_index(pit, shape)
        Id, Jd = np.unravel_index(drain, shape)
        if max_dist:
            b = np.sqrt((ipit - Id) ** 2 + (jpit - Jd) ** 2) <= max_dist
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, Id, Jd = drain[b], Id[b], Jd[b]

        dx = [_fence_mean(dX, ipit, i2) * (jpit - j2) for i2, j2 in zip(Id, Jd)]
        dy = [dY[_ordered_slice(ipit, i2)].sum() for i2 in Id]
        dxy = np.sqrt(np.asarray(dx) ** 2 + np.asarray(dy) ** 2)
        if max_dist_XY:
            b = dxy <= max_dist_XY
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, dxy = drain[b], dxy[b]

        if drain.size > 1:
            drain = drain[dxy == dxy.min()]
        drain = drain[0]
        path += [drain]

        # back-prune path pixels not 8-connected toward the drain (:520-532)
        ip, jp = np.unravel_index(np.asarray(path), shape)
        ip, jp = ip.tolist(), jp.tolist()
        k = len(path) - 2
        while k > 0:
            if abs(ip[k] - ip[k + 1]) <= 1 and abs(jp[k] - jp[k + 1]) <= 1:
                k -= 1
            else:
                path.pop(k)
                ip.pop(k)
                jp.pop(k)
                k = min(k, len(path) - 2)
            if path[k] == pit:
                break

        if e[pit] < e[drain]:
            e[pit] = e[path][e[path] > e[drain]].min()
        si = e[drain] - e[pit]
        e[path] = e[pit] + np.linspace(0, 1, len(path)) * si

    if warn_pits:
        warnings.warn("%d pits had no place to drain to in this chunk"
                      % len(warn_pits))
    return elev


# ---------------------------------------------------------------------------
# pit connectivity for UCA (dem_processing.py:1269-1382)
# ---------------------------------------------------------------------------

def connectivity_pits(flats, elev, mag, dX, dY, max_iter=300, max_dist=32,
                      max_dist_XY=None, min_border=False):
    """Sparse drain links for pits/flats that survived conditioning.

    Returns ``(pit_src, pit_dst, pit_w, flats, mag)``; ``flats``/``mag`` are
    modified copies (drained pits get mag = mean slope, flats cleared).
    """
    flats = flats.copy()
    mag = mag.copy()
    e = elev.ravel()
    shape = elev.shape

    pits_bool = (flats & (elev > 0)).ravel()
    pits = np.where(pits_bool)[0]
    src, dst, wgt = [], [], []
    warn_pits = []
    for pit in pits[np.argsort(e[pits])]:
        area = np.array([pit], "int64")
        drain = None
        epit = e[pit]
        if min_border:
            epit_border = e[_border_flat_indices(area, shape)].min()
        else:
            epit_border = epit
        for _ in range(max_iter):
            border = _border_flat_indices(area, shape)
            if border.size == 0:
                break
            eb = e[border]
            emin = eb.min()
            is_pit = pits_bool[border]
            eb_pits, eb_nopits = eb[is_pit], eb[~is_pit]
            if eb_nopits.size > 0 and eb_nopits.min() < epit_border:
                drain = border[~is_pit][eb_nopits < epit_border]
                break
            if eb_pits.size > 0 and eb_pits.min() < epit:
                drain = border[is_pit][eb_pits < epit]
                break
            area = np.concatenate([area, border[eb == emin]])

        if drain is None:
            warn_pits.append(pit)
            continue

        ipit, jpit = np.unravel_index(pit, shape)
        Id, Jd = np.unravel_index(drain, shape)
        if max_dist:
            b = np.sqrt((ipit - Id) ** 2 + (jpit - Jd) ** 2) <= max_dist
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, Id, Jd = drain[b], Id[b], Jd[b]

        dx = [_fence_mean(dX, ipit, i2) * (jpit - j2) for i2, j2 in zip(Id, Jd)]
        dy = [dY[_ordered_slice(ipit, i2)].sum() for i2 in Id]
        dxy = np.sqrt(np.asarray(dx) ** 2 + np.asarray(dy) ** 2)
        if max_dist_XY:
            b = dxy <= max_dist_XY
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, dxy = drain[b], dxy[b]

        s = np.abs(e[pit] - e[drain]) / dxy
        src += [pit] * drain.size
        dst += drain.tolist()
        wgt += (s / s.sum()).tolist()
        mag[ipit, jpit] = np.mean(s)
        flats[ipit, jpit] = False

    if warn_pits:
        warnings.warn("%d pits had no place to drain to in this chunk"
                      % len(warn_pits))
    return (np.asarray(src, "int64"), np.asarray(dst, "int64"),
            np.asarray(wgt, "float64"), flats, mag)


# ---------------------------------------------------------------------------
# deprecated drain modes (dem_processing.py:1384-1645)
#
# The reference's spill/flats variants are non-default and partly broken
# (matplotlib import inside the spill hot loop :1426; the flats mode's extra
# drain links are concatenated as (i=flat_j, j=flat_j) self-loops :1114-1115;
# spill's second receiver plane is read with an off-by-one stride
# ``border + i12.max()`` :1436).  These implementations reproduce the modes'
# *functioning* semantics — the parts the self-loop/stride bugs were clearly
# meant to compute — as sparse link generators with the same output contract
# as :func:`connectivity_pits`.  Divergences are listed in docs/PARITY.md.
# ---------------------------------------------------------------------------

def receiver_indices(section, shape):
    """Flattened D∞ receiver indices (j1, j2) per pixel, -1 where invalid.

    Host-side analog of ``_mk_connectivity`` (dem_processing.py:1155-1267):
    j1 is the straight-neighbor receiver (facet e1), j2 the diagonal (e2);
    out-of-grid receivers and flat pixels (section -1) are -1.  The
    reference's per-edge facet subsets are equivalent to the in-grid test
    applied per receiver.
    """
    from .stencil import FACET_E1, FACET_E2

    nn, mm = shape
    sec = np.asarray(section).ravel()
    idx = np.arange(nn * mm)
    i, j = idx // mm, idx % mm
    valid = sec >= 0
    s = np.clip(sec, 0, 7)
    out = []
    for table in (FACET_E1, FACET_E2):
        di = np.asarray([t[0] for t in table])[s]
        dj = np.asarray([t[1] for t in table])[s]
        ti, tj = i + di, j + dj
        ok = valid & (ti >= 0) & (ti < nn) & (tj >= 0) & (tj < mm)
        plane = np.full(nn * mm, -1, "int64")
        plane[ok] = ti[ok] * mm + tj[ok]
        out.append(plane)
    return out[0], out[1]


def connectivity_pits_spill(section, flats, elev, mag, dX, dY, max_iter=300,
                            max_dist=32, max_dist_XY=None):
    """Watershed-spill drain links for pits (dem_processing.py:1384-1508).

    Pits are processed in *descending* elevation order; each grows its
    watershed over unclaimed (or earlier-claimed, when nested) pixels until a
    frontier pixel's D∞ receiver escapes the claimed set — a spill point.
    The pit drains with weight 1 to the nearest spill point; its magnitude
    becomes ``|mean((e_pit - e_drains)/dist)|``.  Spill links may run uphill
    (the reference exempts them from the downhill prune at :1130-1134).
    """
    flats = flats.copy()
    mag = mag.copy()
    e = elev.ravel()
    shape = elev.shape
    j1, j2 = receiver_indices(section, shape)

    pits = np.where((flats & (elev > 0)).ravel())[0]
    owner = np.zeros(elev.size, "int64")
    src, dst, wgt = [], [], []
    warn_pits = []
    for pi, pit in enumerate(pits[np.argsort(e[pits])[::-1]]):
        inside = int(owner[pit] > 0)  # nested inside an earlier watershed
        owner[pit] = pi + 1
        border = np.array([pit], "int64")
        drain = np.array([], "int64")
        for _ in range(max_iter):
            border = _border_flat_indices(border, shape)
            border = border[owner[border] <= pi * inside]
            # re-check previous drains: a growing watershed can swallow them
            border = np.concatenate([border, drain])
            owner[border] = pi + 1
            d1, d2 = j1[border], j2[border]
            a_spill = (((owner[d1] <= inside * pi) & (d1 >= 0))
                       | ((owner[d2] <= inside * pi) & (d2 >= 0)))
            drain = border[a_spill]
            owner[drain] = inside * pi
            border = border[~a_spill]
            if a_spill.all() or len(border) == 0:
                break

        if len(drain) == 0:
            warn_pits.append(pit)
            continue

        ipit, jpit = np.unravel_index(pit, shape)
        Id, Jd = np.unravel_index(drain, shape)
        if max_dist:
            b = np.sqrt((ipit - Id) ** 2 + (jpit - Jd) ** 2) <= max_dist
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, Id, Jd = drain[b], Id[b], Jd[b]

        dx = [_fence_mean(dX, ipit, i2) * (jpit - j2_) for i2, j2_ in zip(Id, Jd)]
        dy = [dY[_ordered_slice(ipit, i2)].sum() for i2 in Id]
        dxy = np.sqrt(np.asarray(dx) ** 2 + np.asarray(dy) ** 2)
        if max_dist_XY:
            b = dxy <= max_dist_XY
            if not b.any():
                warn_pits.append(pit)
                continue
            drain, dxy = drain[b], dxy[b]

        s = (e[pit] - e[drain]) / dxy
        if drain.size > 1:
            drain = drain[[np.argmin(dxy)]]
        src += [pit] * drain.size
        dst += drain.tolist()
        wgt += [1.0] * drain.size
        mag[ipit, jpit] = np.abs(np.mean(s))
        flats[ipit, jpit] = False

    if warn_pits:
        warnings.warn("%d pits had no place to drain to in this chunk"
                      % len(warn_pits))
    return (np.asarray(src, "int64"), np.asarray(dst, "int64"),
            np.asarray(wgt, "float64"), flats, mag)


def connectivity_flats(flats, elev, mag, dX):
    """Flat-region drain links (dem_processing.py:1510-1645, deprecated mode).

    Every pixel of a flat drains (weight 1) to the flat's lowest pixel; that
    one pixel drains to the strictly-lower border pixels, proportional to
    their slope magnitude.  Flats with no lower border distribute from their
    lowest pixel across their own grid-edge pixels instead (the area then
    leaves through the tile edge).  The flats/mag masks are *not* updated —
    the reference leaves them untouched in this mode, so flat pixels still
    read NaN in the final UCA while routing area through these links.
    """
    e = elev.ravel()
    magr = np.asarray(mag, "float64").ravel()
    nn, mm = flats.shape
    labels, n_flats = ndi.label(flats, structure=STRUCT8)
    labr = labels.ravel()
    order = np.argsort(labr, kind="stable")
    starts = np.searchsorted(labr[order], np.arange(1, n_flats + 2))

    src, dst, wgt = [], [], []
    warn_flats = []
    loc_dx = dX.mean()
    for ii in range(n_flats):
        ids_flats = order[starts[ii]: starts[ii + 1]]
        border = _border_flat_indices(ids_flats, (nn, mm))
        flat_elev_loc = e[ids_flats]
        # edges can merge two flats; use the lower elevation (:1551-1554)
        flat_elev = flat_elev_loc.min()
        I_filt = e[border] < flat_elev
        loc_slope = magr[border][I_filt]

        if len(loc_slope) == 0:
            # nowhere lower: distribute along the grid edge if the flat
            # touches it (:1572-1592; note the reference's `<= mm` top-row
            # test, kept as-is)
            on_edge = (((ids_flats % mm) == 0) | ((ids_flats % mm) == mm - 1)
                       | (ids_flats <= mm) | (ids_flats >= mm * (nn - 1)))
            if on_edge.sum() == 0:
                warn_flats.append(ii)
                continue
            drain_ids = ids_flats[on_edge]
            loc_proportions = magr[drain_ids].copy()
            loc_proportions /= loc_proportions.sum()
            ids_flats = ids_flats[~on_edge]
            if len(ids_flats) == 0:
                continue  # flat entirely on the edge: inflow just terminates
            flat_elev_loc = flat_elev_loc[~on_edge]
        else:
            # the reference's tolerance test (:1594-1599) admits every
            # strictly-lower border pixel (s + s·dx/2 >= min(s) always holds
            # for s >= 0), i.e. proportions ∝ slope over all of them
            min_edges = (loc_slope + loc_slope * loc_dx / 2) >= loc_slope.min()
            drain_ids = border[I_filt][min_edges]
            loc_proportions = loc_slope[min_edges]
            loc_proportions /= loc_proportions.sum()

        one_id = ids_flats[np.argmin(flat_elev_loc)]
        others = ids_flats[ids_flats != one_id]
        src += others.tolist() + [one_id] * len(drain_ids)
        dst += [one_id] * len(others) + drain_ids.tolist()
        wgt += [1.0] * len(others) + loc_proportions.tolist()

    if warn_flats:
        warnings.warn("%d flats had no place to drain to --> these are pits "
                      "(check pit-remove algorithm)." % len(warn_flats))
    return (np.asarray(src, "int64"), np.asarray(dst, "int64"),
            np.asarray(wgt, "float64"), flats.copy(), mag.copy())
