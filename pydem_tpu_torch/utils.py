"""Reference-compatible utility surface (``pydem.utils`` analog).

The reference ships a public utility module
(``utils.py``) that downstream users import directly
(raster IO helpers, the tile filename codec, region-morphology helpers).
This module exposes the same names on top of this package's implementations so
a switching user's ``from pydem.utils import ...`` lines keep working as
``from pydem_tpu_torch.utils import ...``:

- raster IO: :func:`read_raster`, :func:`save_raster`,
  :func:`dem_processor_from_raster_kwargs`, :func:`mk_dx_dy_from_geotif_layer`
  (the raster handle is this package's own grid object — ``.data``,
  ``.transform``, ``.bounds`` — rather than a rasterio dataset)
- geometry/naming: :func:`mk_transform`, :func:`get_fn`,
  :func:`get_fn_from_coords`
- region morphology (utils.py:208-468): :func:`sortrows`,
  :func:`get_adjacent_index`, :func:`get_border_index`,
  :func:`get_border_mask`, :func:`get_distance`, :func:`find_centroid`,
  :func:`make_slice`, :func:`grow_slice`, :func:`grow_obj`

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/utils.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import numpy as np

from .core.conditioning import (_adjacent_flat_indices, _border_flat_indices,
                                _border_mask, _centroid, _region_distance)
from .geometry import get_fn_from_coords, mk_transform, pixel_scales
from .io.raw import read_raster, read_raster_kwargs

__all__ = [
    "read_raster", "save_raster", "dem_processor_from_raster_kwargs",
    "mk_dx_dy_from_geotif_layer", "mk_transform", "get_fn",
    "get_fn_from_coords", "sortrows", "get_adjacent_index",
    "get_border_index", "get_border_mask", "get_distance", "find_centroid",
    "make_slice", "grow_slice", "grow_obj",
]


def dem_processor_from_raster_kwargs(fn):
    """DEMProcessor constructor kwargs from a raster file
    (utils.py:46-51)."""
    return read_raster_kwargs(fn)


def mk_dx_dy_from_geotif_layer(dataset):
    """Per-row geodesic pixel sizes ``(dX, dY, dX2, dY2)`` for an open
    raster (utils.py:127-174).  ``dataset`` is the grid object returned by
    :func:`read_raster`."""
    return pixel_scales(dataset.transform, dataset.shape[0],
                        projected=getattr(dataset, "projected", False),
                        ellipsoid=getattr(dataset, "ellipsoid", "WGS-84"))


def save_raster(fn, data, crs=4326, transform=None, affine=None):
    """Write a single-band GeoTIFF (utils.py:61-79).  ``crs`` is an EPSG
    code (the reference takes a rasterio CRS object)."""
    from .io.geotiff import write_geotiff

    t = transform if transform is not None else affine
    if t is None:
        raise ValueError("save_raster needs a transform")
    code = int(getattr(crs, "to_epsg", lambda: crs)() or 4326)
    write_geotiff(fn, np.asarray(data), tuple(t)[:6], crs_code=code,
                  projected=code != 4326)
    return fn


def get_fn(elev, name=None):
    """Standard tile filename for a raster-layer-like object with
    ``bounds`` (left, bottom, right, top) — utils.py:81-98."""
    left, bottom, right, top = elev.bounds
    return get_fn_from_coords((bottom, left, top, right), name)


def sortrows(a, i=0, index_out=False, recurse=True):
    """Sort array rows by column ``i``, recursively refining ties by the
    remaining columns (utils.py:208-253 semantics via a stable lexsort)."""
    a = np.asarray(a)
    if recurse:
        cols = [a[:, j] for j in range(a.shape[1] - 1, -1, -1) if j != i]
        I = np.lexsort(tuple(cols) + (a[:, i],))
    else:
        I = np.argsort(a[:, i], kind="stable")
    out = a[I, :]
    if index_out:
        return out, I
    return out


def get_adjacent_index(I, shape, size):
    """Flattened indices 8-adjacent to the index set ``I``
    (utils.py:270-311).  ``size`` (= rows*cols) is accepted for signature
    parity."""
    del size
    return _adjacent_flat_indices(np.asarray(I, "int64"), shape)


def get_border_index(I, shape, size):
    """Adjacent minus the set itself, sorted ascending (utils.py:313-340)."""
    del size
    return _border_flat_indices(np.asarray(I, "int64"), shape)


def get_border_mask(region):
    """Boolean border ring of a region mask (utils.py:342-372)."""
    return _border_mask(np.asarray(region, bool))


def get_distance(region, src):
    """In-region chamfer distance from ``src`` pixels (orth +1, diag +√2;
    utils.py:374-402 incl. its reached-everywhere early stop)."""
    return _region_distance(np.asarray(region, bool), np.asarray(src, bool))


def find_centroid(region):
    """In-region pixel nearest the center of mass (utils.py:450-468)."""
    return _centroid(np.asarray(region, bool))


def make_slice(a, b):
    """Ordered slice (utils.py:404-408)."""
    return slice(a, b) if a < b else slice(b, a)


def grow_slice(slc, size):
    """Grow a slice by 1 in each direction, clipped (utils.py:410-428)."""
    return slice(max(0, slc.start - 1), min(size, slc.stop + 1))


def grow_obj(obj, shape):
    """Grow a 2-d find_objects bbox by 1, clipped (utils.py:430-447)."""
    return grow_slice(obj[0], shape[0]), grow_slice(obj[1], shape[1])
