"""Geodesic grid geometry: per-row pixel sizes on an ellipsoid.

Vectorized replacement for the reference's geopy-based per-row loops
(``utils.py:127-174``).  The reference calls
``geopy.distance.distance`` (Karney geodesic) once per latitude row in four
Python loops; here the whole set of row distances is computed with a single
vectorized Vincenty inverse solve over all rows at once (Vincenty agrees with
Karney to well below 1e-9 relative for the sub-degree spans that arise between
raster rows, and is branch-free/vectorizable).

The outputs follow the reference's exact conventions, quirks included:

- ``dX``/``dY``: 'fence' spacings, length ``nrows - 1``; computed at row
  centers offset by half a pixel (``utils.py:153-163``).
- ``dX2``/``dY2``: 'post' spacings, length ``nrows``; computed at rows offset
  by one full pixel (``utils.py:165-172``) — NOT centered.  This asymmetry is
  part of the reference numerics and is reproduced.
- Latitudes are clipped to [-90, 90] (``utils.py:160-172``).
- For projected CRS, constant |transform.a| / |transform.e| spacings
  (``utils.py:132-137``).

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/geometry.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import numpy as np

# (name, major axis [m], minor axis [m]); flattening derived.
# Same parameter set geopy exposes; the reference selects by the SPHEROID /
# ELLIPSOID name found in the CRS WKT (utils.py:139-151).
ELLIPSOIDS = {
    "WGS-84": (6378137.0, 6356752.314245),
    "GRS-80": (6378137.0, 6356752.314140),
    "GRS-1980": (6378137.0, 6356752.314140),
    "Airy-(1830)": (6377563.396, 6356256.909),
    "Intl-1924": (6378388.0, 6356911.946),
    "Clarke-(1880)": (6378249.145, 6356514.870),
    "Clarke-(1866)": (6378206.4, 6356583.8),
    "WGS-72": (6378135.0, 6356750.520016),
}


def vincenty_inverse(lat1, lon1, lat2, lon2, ellipsoid="WGS-84", tol=1e-12, maxiter=200):
    """Vectorized Vincenty inverse geodesic distance in meters.

    All-lat/lon arguments broadcast together.  Coincident points return 0.
    """
    a, b = ELLIPSOIDS[ellipsoid]
    f = (a - b) / a

    lat1, lon1, lat2, lon2 = np.broadcast_arrays(
        *[np.asarray(x, dtype="float64") for x in (lat1, lon1, lat2, lon2)]
    )
    phi1, phi2 = np.radians(lat1), np.radians(lat2)
    L = np.radians(lon2 - lon1)

    U1 = np.arctan((1 - f) * np.tan(phi1))
    U2 = np.arctan((1 - f) * np.tan(phi2))
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)

    lam = L.copy()
    for _ in range(maxiter):
        sinlam, coslam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt(
            (cosU2 * sinlam) ** 2 + (cosU1 * sinU2 - sinU1 * cosU2 * coslam) ** 2
        )
        cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * coslam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(sin_sigma != 0, cosU1 * cosU2 * sinlam / np.where(sin_sigma == 0, 1, sin_sigma), 0.0)
        cos2_alpha = 1.0 - sin_alpha**2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos2sig_m = np.where(
                cos2_alpha != 0,
                cos_sigma - 2 * sinU1 * sinU2 / np.where(cos2_alpha == 0, 1, cos2_alpha),
                0.0,  # equatorial line
            )
        C = f / 16.0 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        lam_new = L + (1 - C) * f * sin_alpha * (
            sigma
            + C * sin_sigma * (cos2sig_m + C * cos_sigma * (-1 + 2 * cos2sig_m**2))
        )
        if np.all(np.abs(lam_new - lam) < tol):
            lam = lam_new
            break
        lam = lam_new

    sinlam, coslam = np.sin(lam), np.cos(lam)
    sin_sigma = np.sqrt(
        (cosU2 * sinlam) ** 2 + (cosU1 * sinU2 - sinU1 * cosU2 * coslam) ** 2
    )
    cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * coslam
    sigma = np.arctan2(sin_sigma, cos_sigma)
    with np.errstate(divide="ignore", invalid="ignore"):
        sin_alpha = np.where(sin_sigma != 0, cosU1 * cosU2 * sinlam / np.where(sin_sigma == 0, 1, sin_sigma), 0.0)
    cos2_alpha = 1.0 - sin_alpha**2
    with np.errstate(divide="ignore", invalid="ignore"):
        cos2sig_m = np.where(
            cos2_alpha != 0,
            cos_sigma - 2 * sinU1 * sinU2 / np.where(cos2_alpha == 0, 1, cos2_alpha),
            0.0,
        )
    u2 = cos2_alpha * (a**2 - b**2) / b**2
    A = 1 + u2 / 16384.0 * (4096 + u2 * (-768 + u2 * (320 - 175 * u2)))
    B = u2 / 1024.0 * (256 + u2 * (-128 + u2 * (74 - 47 * u2)))
    dsigma = (
        B
        * sin_sigma
        * (
            cos2sig_m
            + B
            / 4.0
            * (
                cos_sigma * (-1 + 2 * cos2sig_m**2)
                - B
                / 6.0
                * cos2sig_m
                * (-3 + 4 * sin_sigma**2)
                * (-3 + 4 * cos2sig_m**2)
            )
        )
    )
    s = b * A * (sigma - dsigma)
    return np.where(sin_sigma == 0, 0.0, s)


def pixel_scales(transform, nrows, projected=False, ellipsoid="WGS-84"):
    """Per-row pixel sizes (dX, dY, dX2, dY2) in meters.

    ``transform`` is a 6-tuple GDAL-style affine ``(a, b, c, d, e, f)`` with
    ``x = a*col + b*row + c``, ``y = d*col + e*row + f`` — i.e. ``a`` = lon
    step, ``e`` = lat step (negative for north-up), ``c`` = west edge,
    ``f`` = north edge.

    Mirrors ``utils.py:127-174`` exactly — including its quirk of evaluating
    dX at longitude ``transform.d + dx/2`` (the affine row-shear term, i.e.
    ~0 for axis-aligned rasters; harmless since same-latitude distance
    depends only on the longitude difference).
    """
    a_, b_, c_, d_, e_, f_ = transform
    if projected:
        dX = np.ones(nrows - 1) * a_
        dX2 = np.ones(nrows) * a_
        dY = np.abs(np.ones(nrows - 1) * e_)
        dY2 = np.abs(np.ones(nrows) * e_)
        return dX, dY, dX2, dY2

    dx = a_
    dy = e_

    # fence grid (length nrows-1), lat anchored at first row center
    lon = d_ + dx / 2.0
    lat = f_ + dy / 2.0
    j = np.arange(nrows - 1)
    latsX = np.clip(lat + dy * (j + 1), -90, 90)
    dX = vincenty_inverse(latsX, lon + dx, latsX, lon, ellipsoid)
    latsY0 = np.clip(lat + dy * j, -90, 90)
    latsY1 = np.clip(lat + dy * (j + 1), -90, 90)
    dY = vincenty_inverse(latsY0, lon, latsY1, lon, ellipsoid)

    # post grid (length nrows), lat anchored one full pixel in (utils.py:165-166)
    lon2 = d_ + dx
    lat2 = f_ + dy
    j2 = np.arange(nrows)
    latsX2 = np.clip(lat2 + dy * (j2 + 1), -90, 90)
    dX2 = vincenty_inverse(latsX2, lon2 + dx, latsX2, lon2, ellipsoid)
    latsY20 = np.clip(lat2 + dy * j2, -90, 90)
    latsY21 = np.clip(lat2 + dy * (j2 + 1), -90, 90)
    dY2 = vincenty_inverse(latsY20, lon2, latsY21, lon2, ellipsoid)

    return dX, dY, dX2, dY2


def get_fn_from_coords(coords, name=None):
    """Standard tile filename from (LLC.lat, LLC.lon, URC.lat, URC.lon)
    (utils.py:101-124): e.g. ``N45o5W-72_N46W-71o5_elev.tif``."""
    NS1 = ["S", "N"][coords[0] > 0]
    EW1 = ["W", "E"][coords[1] > 0]
    NS2 = ["S", "N"][coords[2] > 0]
    EW2 = ["W", "E"][coords[3] > 0]
    new_name = "%s%0.3g%s%0.3g_%s%0.3g%s%0.3g" % (
        NS1, coords[0], EW1, coords[1], NS2, coords[2], EW2, coords[3])
    if name is not None:
        new_name += "_" + name
    return new_name.replace(".", "o") + ".tif"


def mk_transform(lat_top, lon_left, dlat, dlon, lat_lon_centered=False):
    """GDAL-style 6-tuple affine for a north-up geographic raster.

    Mirrors ``utils.py:53-59``.
    """
    if lat_lon_centered:
        lat_top -= dlat / 2.0
        lon_left -= dlon / 2.0
    return (dlon, 0.0, lon_left, 0.0, dlat, lat_top)
