"""Per-row pixel spacings of a geographic (latitude/longitude) tile.

The harness's own formula, independent of the program's: on the WGS-84
ellipsoid the east-west length of ``dlon`` degrees along the parallel at
latitude ``phi`` is ``N(phi) cos(phi) dlon`` and the north-south length of
``dlat`` degrees about ``phi`` is ``M(phi) dlat``, with the prime-vertical
and meridional radii of curvature ``N`` and ``M``.  Over one pixel (3" or
1") these agree with a geodesic to better than 1e-9 relative.

The spacings follow the conventions of the program's entry points:
``dX``, ``dY`` (n - 1 values) are the spacings between the centres of rows
``j`` and ``j + 1`` (``dX`` along the parallel half way between them);
``dX2``, ``dY2`` (n values) are the width and height of row ``j``'s pixels,
whose product is a pixel's area.
"""
from __future__ import annotations

import numpy as np

A = 6378137.0  # WGS-84 semi-major axis, m
F = 1 / 298.257223563  # WGS-84 flattening
E2 = F * (2 - F)


def _radii(lat_deg):
    s = np.sin(np.radians(lat_deg))
    w = 1 - E2 * s * s
    return A / np.sqrt(w), A * (1 - E2) / w ** 1.5  # N, M


def east_west_m(lat_deg, dlon_deg):
    n_rad, _ = _radii(lat_deg)
    return n_rad * np.cos(np.radians(lat_deg)) * np.radians(dlon_deg)


def north_south_m(lat_deg, dlat_deg):
    _, m_rad = _radii(lat_deg)
    return m_rad * np.radians(dlat_deg)


def spacings(rows, north, step_deg, first_row_offset):
    """``(dX, dY, dX2, dY2)`` in metres, float64, for ``rows`` rows of
    pixels ``step_deg`` apart whose first row's centre lies
    ``first_row_offset`` pixels south of latitude ``north`` (0.5 for
    pixel-is-area rasters such as MERIT Hydro, 0 for pixel-is-point ones
    such as SRTM, whose 3601 rows run from edge to edge)."""
    centre = north - (np.arange(rows) + first_row_offset) * step_deg
    fence = (centre[:-1] + centre[1:]) / 2
    dX = east_west_m(fence, step_deg)
    dY = north_south_m(fence, step_deg)
    dX2 = east_west_m(centre, step_deg)
    dY2 = north_south_m(centre, step_deg)
    return dX, dY, dX2, dY2


def tile_spacings(config):
    """The spacings of a configuration's tile (its ``geometry`` block)."""
    g = config["geometry"]
    return spacings(config["shape"][0], g["north"], g["step_arcsec"] / 3600.0,
                    g["first_row_offset"])
