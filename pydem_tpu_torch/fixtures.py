"""Analytic DEM test fixtures.

Pure-numpy ports of the reference's in-package fixture generators
(``utils_test_pydem.py:98-356, 412-515``): cones with
analytic UCA, the 8 planar ramps, opposing slopes, ring/top/line flats with
configurable drains, pits, troughs, masked no-data cases, the spiral maze, and
geodesically-scaled variants.  No file IO — generators return arrays directly
(the reference round-trips through GeoTIFFs; our IO layer is tested
separately).

Masked ("no-data") pixels are filled with ``NO_DATA_VALUE`` exactly as the
reference's ``make_elev_ang`` does via ``np.ma.filled``
(``utils_test_pydem.py:69-70``), so case 28/29 parity holds bit-for-bit.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/fixtures.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import os

import numpy as np

from .geometry import mk_transform, pixel_scales

NO_DATA_VALUE = -9999


def _ma(arr, mask=None):
    return np.ma.masked_array(
        arr, mask=np.zeros(arr.shape, bool) if mask is None else mask,
        fill_value=NO_DATA_VALUE)


def mk_xy(N):
    """The [-1, 1] index grid used by most cases (utils_test_pydem.py:422)."""
    return np.mgrid[-1: 1: complex(0, N), -1: 1: complex(0, N)]


def mk_xy_latlon(N, lat=(46, 45), lon=(-73, -72)):
    """Geodesically-scaled coordinate grid (utils_test_pydem.py:48-64).

    Builds the per-row geodesic spacings for an N×N tile spanning
    lat 46..45, lon -73..-72 (pixel-centered), cumsums them into physical
    coordinates, centers on zero, and normalizes by the max radius.
    """
    pixel_height = -abs(lat[0] - lat[1]) / (N - 1.0)
    pixel_width = abs(lon[0] - lon[1]) / (N - 1.0)
    transform = mk_transform(max(lat), min(lon), pixel_height, pixel_width,
                             lat_lon_centered=True)
    dx, dy, _, _ = pixel_scales(transform, N)
    y = np.concatenate([[0], np.cumsum(dx)])
    x = np.concatenate([[0], np.cumsum(dy)])
    x = x - (x.max() - x.min()) / 2.0
    y = y - (y.max() - y.min()) / 2.0
    scale = np.sqrt(x**2 + y**2).max()
    x = x / scale
    y = y / scale
    Y, X = np.meshgrid(y, x)
    return X, Y


# ---------------------------------------------------------------------------
# individual cases (same analytic forms as utils_test_pydem.py:98-356)
# ---------------------------------------------------------------------------

def case_cone(x, y, noise=False):
    NN = x.shape[0]
    raster = _ma(1 - np.sqrt(y**2 + x**2) / np.sqrt(2.0))
    angle = _ma(np.arctan2(x, -y) + np.pi)
    ncell = np.round(np.sqrt(y**2 + x**2) / (1.0 / NN))
    with np.errstate(divide="ignore", invalid="ignore"):
        uca = _ma(np.pi * (y**2 + x**2) / ncell * NN**2 / 4.0)
    summat = np.zeros_like(uca)
    summat[:, 0] = 1
    summat[:, -1] = 1
    summat[0, :] = 1
    summat[-1, :] = 1
    uca = uca * NN**2 / np.nansum(summat * uca)
    if noise:
        from scipy.ndimage import gaussian_filter

        np.random.seed(1773)
        raster = raster + np.abs(np.random.randn(*raster.shape) ** 2) * 0.0003
        raster[:, :] = gaussian_filter(raster, 2, mode="constant")
    return raster, angle, uca


def case_cone_scaled(x, y, noise=False):
    raster, angle, uca = case_cone(x, y, noise)
    raster = raster - raster.ravel().min()
    return raster, angle, uca


def case_line(x, y, line):
    raster = _ma(line[0] * x + line[1] * y)
    raster = raster - raster.min()
    raster = raster / raster.max()
    angle = _ma(np.arctan2(-line[0], line[1]) * np.ones(raster.shape) + np.pi)
    NN = x.shape[0]
    x_line = 1 if line[0] > 0 else -1
    y_line = 1 if line[1] > 0 else -1
    tx = (x_line - x) / (line[0] + 1e-17)
    ty = (y_line - y) / (line[1] + 1e-17)
    if line[0] == 0:
        t = ty
    elif line[1] == 0:
        t = tx
    else:
        t = np.minimum(tx, ty)
    uca = _ma(np.round(t * NN) / 2)
    return raster, angle, uca


def case_opposing_slopes(x, y, line):
    raster = _ma(line[0] * x + line[1] * y)
    I = -x * line[1] + y * line[0] > 0
    raster[I] = -line[0] * x[I] - line[1] * y[I]
    raster = raster - raster.min()
    raster = raster / raster.max()
    angle = _ma(np.arctan2(-line[0], line[1]) * np.ones(raster.shape) + np.pi)
    angle[I] = np.arctan2(line[0], -line[1]) + np.pi
    return raster, angle


def case_ring_flat(x, y, drains):
    raster, angle, _uca = case_cone(x, y)
    if type(drains[0]) != list:
        drains = [drains]
    I1 = raster >= 0.7
    I = (raster > 0.5) & (raster < 0.7)
    angle[I] = -1
    raster2 = raster.copy()
    for drain in drains:
        raster[drain[0], drain[1]] -= np.min(raster[drain[0], drain[1]])
    raster[I] = 0.51
    raster[I1] = raster2[I1]
    return raster, angle


def case_top_flat(x, y, drains):
    raster, angle, _uca = case_cone(x, y)
    if type(drains[0]) != list:
        drains = [drains]
    I = raster >= 0.7
    angle[I] = -1
    for drain in drains:
        raster[drain[0], drain[1]] -= np.min(raster[drain[0], drain[1]])
    raster[I] = 0.75
    return raster, angle


def case_line_flat(x, y, line):
    raster, angle, _uca = case_line(x, y, line)
    flat_raster = _ma(1 - np.sqrt(y**2 + x**2) / np.sqrt(2.0))
    raster = raster - raster.min()
    raster = raster / raster.max()
    I = flat_raster >= 0.7
    raster[I] = 0.5
    angle[I] = -1
    return raster, angle


def case_pit_of_dispair(x, y, drains):
    if len(drains) > 0 and type(drains[0]) != list:
        drains = [drains]
    raster = _ma(1 + np.sqrt(y**2 + x**2) / np.sqrt(2.0))
    angle = _ma(np.arctan2(-x, y) + np.pi)
    for drain in drains:
        N = len(raster[drain[0], drain[1]].ravel())
        raster[drain[0], drain[1]] = np.linspace(0, 1, N).reshape(
            raster[drain[0], drain[1]].shape)
    return raster, angle


def case_trough_of_dispair(x, y, line):
    NN = x.shape[0]
    raster = _ma(line[0] * x + line[1] * y)
    I = x * line[1] + y * line[0] > 0
    raster[I] = -line[0] * x[I] - line[1] * y[I]
    raster += 0.1 * (-line[0] * x + line[1] * y)
    raster = raster - raster.min()
    raster = raster / raster.max()
    angle = _ma(np.arctan2(-line[0] * 0.9, line[1] * 1.1)
                * np.ones(raster.shape) + np.pi)
    angle[I] = np.arctan2(line[0] * 1.1, -line[1] * 0.9) + np.pi
    angle[[np.arange(NN), np.arange(NN)]] = 3 * np.pi / 4
    return raster, angle


def case_pit_of_carkoon(x, y):
    raster, angle = case_pit_of_dispair(x, y, [])
    I = np.argmin(raster)
    raster.mask.ravel()[I] = True
    angle.mask.ravel()[I] = True
    return raster, angle


def case_sea_of_saw(x, y):
    raster, angle, _uca = case_cone(x, y)
    I = (raster < 0.4) & (x > 0)
    raster.mask[I] = True
    angle.mask[I] = True
    return raster, angle


def spiral(x, y):
    """Double-armed inward spiral channel carved into a rounded pyramid.

    A turtle walks the canvas between two corners of a shrinking active
    window — axis 0 first, then axis 1, reversing (and pulling the corner
    behind it inward by 2) each time it lands on the target corner — and
    writes ascending elevations along half the canvas.  Output is
    bit-identical to the reference fixture's spiral state machine
    (utils_test_pydem.py:315-356), verified element-wise over sizes 4..70
    and non-square canvases; only the formulation differs.
    """
    n, m = x.shape
    raster = _ma((1.0 - np.maximum(np.abs(x), np.abs(y)) ** 2)
                 * (n * m) / 2 + (n + m) * 2)
    lo = np.array([-1, 1])         # active window: exclusive low corner,
    hi = np.array([n - 2, m - 2])  # inclusive high corner
    pos = np.array([0, 1])
    inward = True                  # toward hi corner, else toward lo
    for elev in range(int(n * m / 2)):
        raster[pos[0], pos[1]] = elev
        tgt = hi if inward else lo
        step = 1 if inward else -1
        if (pos[0] - tgt[0]) * step < 0:
            pos[0] += step         # run along axis 0 first
        elif (pos[1] - tgt[1]) * step < 0:
            pos[1] += step         # then along axis 1
        elif (pos == tgt).all():   # landed on the corner: reverse
            (lo if inward else hi)[:] += 2 * step  # shrink behind us
            inward = not inward
            pos[0] -= step
        else:
            break
    return raster, raster * 0


# ---------------------------------------------------------------------------
# case registry (utils_test_pydem.py:426-488); case 27 (real data) omitted —
# the bundled tile is loaded directly by tests via the io layer.
# ---------------------------------------------------------------------------

def mk_test_multifile(testnum, NN, testdir, nx_grid=3, ny_grid=4,
                      nx_overlap=16, ny_overlap=32, lat=(46, 45),
                      lon=(-73, -72)):
    """Split a fixture into a grid of overlapping GeoTIFF tiles
    (semantics of utils_test_pydem.py:359-408); returns the chunk dir."""
    from .io.geotiff import write_geotiff
    from .geometry import mk_transform

    path = os.path.join(testdir, "chunks")
    os.makedirs(path, exist_ok=True)

    def chunk_edges(NN_, chunk_size, chunk_overlap):
        chunk_size = int(chunk_size)
        left = np.arange(0, NN_ - chunk_overlap, chunk_size)
        left[1:] -= chunk_overlap // 2
        right = np.arange(0, NN_ - chunk_overlap, chunk_size)
        right[:-1] = right[1:] + int(np.ceil(chunk_overlap / 2))
        right[-1] = NN_
        right = np.minimum(right, NN_)
        return left, right

    elev, _ang, _uca = get_test_case(testnum, NN)
    ni, nj = elev.shape
    top_edge, bottom_edge = chunk_edges(ni, np.ceil(ni / ny_grid), ny_overlap)
    left_edge, right_edge = chunk_edges(nj, np.ceil(nj / nx_grid), nx_overlap)
    lats = np.linspace(lat[0], lat[1], ni)
    lons = np.linspace(lon[0], lon[1], nj)
    count = 0
    for te, be in zip(top_edge, bottom_edge):
        for le, re_ in zip(left_edge, right_edge):
            count += 1
            block = elev[te:be, le:re_]
            ph = -abs(lats[te] - lats[be - 1]) / (block.shape[0] - 1.0)
            pw = abs(lons[le] - lons[re_ - 1]) / (block.shape[1] - 1.0)
            transform = mk_transform(max(lats[te], lats[be - 1]),
                                     min(lons[le], lons[re_ - 1]), ph, pw,
                                     lat_lon_centered=True)
            fn = os.path.join(path, "chunk_%03d_elev.tif" % count)
            write_geotiff(fn, block, transform, nodata=NO_DATA_VALUE)
    return path


def get_test_case(testnum, NN):
    """Return ``(elev, angle, uca_or_None)`` as plain float64 ndarrays.

    Masked pixels are filled with NO_DATA_VALUE (parity with
    ``make_elev_ang``, utils_test_pydem.py:69-70).
    """
    N = max(NN) if isinstance(NN, (list, tuple)) else NN
    x, y = mk_xy(N)
    lat, lon = mk_xy_latlon(N)
    half = N // 2

    cases = {
        0: lambda: case_cone(x, y),
        1: lambda: case_line(x, y, [1, 0]),
        2: lambda: case_line(x, y, [-1, 0]),
        3: lambda: case_line(x, y, [0, 1]),
        4: lambda: case_line(x, y, [0, -1]),
        5: lambda: case_line(x, y, [1, 1]),
        6: lambda: case_line(x, y, [-1, 1]),
        7: lambda: case_line(x, y, [1, -1]),
        8: lambda: case_line(x, y, [-1, -1]),
        9: lambda: case_opposing_slopes(x, y, [1, 0]),
        10: lambda: case_opposing_slopes(x, y, [0, 1]),
        11: lambda: case_opposing_slopes(x, y, [1, 1]),
        12: lambda: case_opposing_slopes(x, y, [-1, 1]),
        13: lambda: case_ring_flat(x, y, [slice(N), slice(N)]),
        14: lambda: case_ring_flat(x, y, [slice(half, half + 1), slice(half, N)]),
        15: lambda: case_ring_flat(x, y, [[slice(half, half + 1), slice(0, half)],
                                          [slice(half, half + 1), slice(half, N)]]),
        16: lambda: case_ring_flat(x, y, [[slice(half, N), slice(half, half + 1)],
                                          [slice(half, half + 1), slice(0, half)],
                                          [slice(half, half + 1), slice(half, N)]]),
        17: lambda: case_ring_flat(x, y, [[slice(0, half), slice(half, half + 1)],
                                          [slice(half, N), slice(half, half + 1)],
                                          [slice(half, half + 1), slice(0, half)],
                                          [slice(half, half + 1), slice(half, N)]]),
        18: lambda: case_top_flat(x, y, [slice(N), slice(N)]),
        19: lambda: case_top_flat(x, y, [slice(half, half + 1), slice(half, N)]),
        20: lambda: case_top_flat(x, y, [slice(half, half + 1), slice(0, half)]),
        21: lambda: case_top_flat(x, y, [slice(half, N), slice(half, half + 1)]),
        22: lambda: case_top_flat(x, y, [slice(0, half), slice(half, half + 1)]),
        23: lambda: case_line_flat(x, y, [-1, -1]),
        24: lambda: case_pit_of_dispair(x, y, [slice(half, half + 1), slice(0, half)]),
        25: lambda: case_pit_of_dispair(x, y, [slice(0, half), slice(half, half + 1)]),
        26: lambda: case_trough_of_dispair(x, y, [-1, 1]),
        28: lambda: case_pit_of_carkoon(x, y),
        29: lambda: case_sea_of_saw(x, y),
        30: lambda: spiral(x, y),
        31: lambda: case_cone(x, y, True),
        32: lambda: case_cone_scaled(lon, lat, True),
        # NOTE: the reference's list has a duplicate comment for 32/33; the
        # actual indexing makes 33 case_cone(x,y,False) and 34 the scaled
        # non-noisy cone.  mk_test_multifile(TEST_NUM=33) therefore builds the
        # *plain* cone (utils_test_pydem.py:486).
        33: lambda: case_cone(x, y, False),
        34: lambda: case_cone_scaled(lon, lat, False),
    }
    res = cases[testnum]()
    raster, angle = res[0], res[1]
    uca = res[2] if len(res) == 3 else None
    elev = np.ma.filled(raster.astype("float64"))
    ang = np.ma.filled(angle.astype("float64"))
    uca_f = None if uca is None else np.ma.filled(uca.astype("float64"), np.nan)
    return elev, ang, uca_f
