"""Headerless/raw raster formats: SRTM ``.hgt`` and ESRI ``.flt`` grids.

The reference reads these through rasterio/GDAL (``utils.py:43-51``, any
format GDAL reads); the from-scratch IO layer implements the two raw formats
that actually appear in DEM workflows — SRTM height tiles (the most common
source data) and ESRI float grids — and exposes one dispatching
:func:`read_raster` used by the tile manager and the DEMProcessor
constructor.  Both parse into the same :class:`~.geotiff.GeoTiff` container
as the TIFF reader, so everything downstream (pixel scales, tile-grid
discovery, exports) is format-agnostic.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/io/raw.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import os
import re

import numpy as np

from .geotiff import GeoTiff, read_geotiff


def _hgt_corner(fn):
    """SW-corner (lat, lon) from an SRTM tile name like ``N40W105.hgt``."""
    m = re.match(r"([NSns])(\d{1,2})([EWew])(\d{1,3})",
                 os.path.basename(fn))
    if not m:
        raise ValueError(
            "Cannot parse SRTM corner from filename %r (expected e.g. "
            "N40W105.hgt)" % fn)
    lat = int(m.group(2)) * (1 if m.group(1).upper() == "N" else -1)
    lon = int(m.group(4)) * (1 if m.group(3).upper() == "E" else -1)
    return lat, lon


def read_hgt(fn, header_only=False):
    """SRTM ``.hgt``: a headerless square of big-endian int16 samples
    covering a 1°×1° cell inclusive of both edges (pixel-is-point), SW
    corner encoded in the filename.  1201² = SRTM3, 3601² = SRTM1.
    Nodata is -32768."""
    lat, lon = _hgt_corner(fn)
    nbytes = os.path.getsize(fn)
    n = int(round((nbytes // 2) ** 0.5))
    if n * n * 2 != nbytes:
        raise ValueError("%r is not a square int16 grid (%d bytes)"
                         % (fn, nbytes))
    step = 1.0 / (n - 1)
    # GDAL's model: pixel-is-point samples exposed as area pixels centered
    # on the posts -> origin half a pixel out from the NW post
    transform = (step, 0.0, lon - step / 2, 0.0, -step, lat + 1 + step / 2)
    data = None
    if not header_only:
        data = np.fromfile(fn, dtype=">i2").reshape(n, n).astype("=i2")
    return GeoTiff(data, transform, crs_code=4326, nodata=-32768,
                   projected=False, shape=(n, n))


def read_flt(fn, header_only=False):
    """ESRI ``.flt``: raw float32 grid with a ``.hdr`` sidecar
    (ncols/nrows/xll{corner,center}/cellsize/NODATA_value/byteorder)."""
    hdr_fn = os.path.splitext(fn)[0] + ".hdr"
    hdr = {}
    with open(hdr_fn) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                hdr[parts[0].lower()] = parts[1]
    ncols = int(hdr["ncols"])
    nrows = int(hdr["nrows"])
    cell = float(hdr["cellsize"])
    if "xllcorner" in hdr:
        x0 = float(hdr["xllcorner"])
        y0 = float(hdr["yllcorner"])
    else:
        x0 = float(hdr["xllcenter"]) - cell / 2
        y0 = float(hdr["yllcenter"]) - cell / 2
    nodata = float(hdr.get("nodata_value", hdr.get("nodata", -9999)))
    bo = "<" if hdr.get("byteorder", "LSBFIRST").upper().startswith("LSB") \
        else ">"
    transform = (cell, 0.0, x0, 0.0, -cell, y0 + nrows * cell)
    data = None
    if not header_only:
        data = (np.fromfile(fn, dtype=bo + "f4")
                .reshape(nrows, ncols).astype("=f4"))
    # .flt carries no CRS; ESRI convention ships a .prj sidecar — detect
    # projected vs geographic by coordinate magnitude when absent
    projected = abs(x0) > 360 or abs(y0) > 180
    prj_fn = os.path.splitext(fn)[0] + ".prj"
    if os.path.exists(prj_fn):
        with open(prj_fn) as f:
            projected = "PROJCS" in f.read().upper()
    return GeoTiff(data, transform, crs_code=4326, nodata=nodata,
                   projected=projected, shape=(nrows, ncols))


_READERS = {
    ".hgt": read_hgt,
    ".flt": read_flt,
}


def read_raster(fn, header_only=False, **kw):
    """Dispatch on extension: TIFF/BigTIFF or a raw format."""
    ext = os.path.splitext(fn)[1].lower()
    reader = _READERS.get(ext)
    if reader is not None:
        return reader(fn, header_only=header_only)
    return read_geotiff(fn, header_only=header_only, **kw)


def read_raster_kwargs(fn):
    """File → DEMProcessor constructor kwargs, any supported format
    (semantics of utils.py:46-51)."""
    g = read_raster(fn)
    data = g.data
    if g.nodata is not None and data is not None and \
            np.issubdtype(data.dtype, np.integer):
        data = np.where(data == g.nodata, np.nan, data.astype("float64"))
    dX, dY, dX2, dY2 = g.pixel_scales()
    return dict(elev=data, dX=dX, dY=dY, dX2=dX2, dY2=dY2,
                bounds=list(g.bounds), transform=list(g.transform))
