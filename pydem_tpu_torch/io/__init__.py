"""Raster IO without GDAL: a copy of ``pydem_tpu/io/__init__.py``."""
from .geotiff import (GeoTiff, read_geotiff, read_geotiff_kwargs,  # noqa: F401
                      write_geotiff)
from .raw import (read_flt, read_hgt, read_raster,  # noqa: F401
                  read_raster_kwargs)
