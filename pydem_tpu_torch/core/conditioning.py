"""Host-side pit drain-path carving (numpy/scipy, as in the JAX package).

Port of ``drain_pit_paths`` and the helpers it calls from
``pydem_tpu/core/conditioning.py`` (the reference pyDEM's
``calc_pit_drain_paths``, dem_processing.py:428-548).  It is serial,
data-dependent host code: the device chain downloads the elevation, carves
it here (with the C++ kernel of :mod:`pydem_tpu_torch.native`, or the numpy
loop below, its plain twin) and uploads only the carved pixels.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy import ndimage as ndi


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


def _ordered_slice(a, b):
    return slice(a, b) if a < b else slice(b, a)


def _fence_mean(dX, i1, i2):
    """Mean fence spacing between rows i1 and i2 (dem_processing.py:1993-1997)."""
    if i1 == i2:
        return dX[min(i1, dX.size - 1)]
    return dX[_ordered_slice(i1, i2)].mean()


def _sea_mask(elev, below_sea):
    return (elev != 0) if below_sea else (elev > 0)


def drain_pit_paths(elev, dX, dY, max_iter=300, max_dist=32, max_dist_XY=None,
                    below_sea=False, native=None):
    """Carve a monotone elevation ramp from each pit to the nearest lower
    drain along a min-elevation growth path.  Returns a new float64 array.

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
