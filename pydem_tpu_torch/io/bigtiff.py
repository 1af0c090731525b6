"""Streaming tiled GeoTIFF / BigTIFF writer with embedded overview IFDs.

The reference exports through rasterio with ``tiled=True, compress='LZW',
bigtiff='YES'`` plus ``build_overviews`` (``
process_manager.py:786-931``).  This is the equivalent for the huge-raster
regime without GDAL: tiles are Deflate-compressed and appended to the file
as they arrive (any order, O(tile) memory), overview levels are additional
reduced-resolution IFDs (``NewSubfileType=1`` — the GDAL embedded-overview
convention), and the IFD chain is written at close.  Classic TIFF is used
when everything fits in 32-bit offsets; BigTIFF (version 43, 8-byte
offsets) otherwise or on request.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/io/bigtiff.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_FMT = {"u": 1, "i": 2, "f": 3}


class TiledTiffWriter:
    """Write one raster + overview pyramid, streaming tile by tile."""

    def __init__(self, fn, shape, dtype, transform=None, crs_code=4326,
                 nodata=None, tile=256, bigtiff="auto", compress=True,
                 projected=False):
        self.fn = fn
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype).newbyteorder("<")
        self.transform = transform
        self.crs_code = crs_code
        self.nodata = nodata
        self.tile = int(tile)
        self.compress = compress
        self.projected = projected
        if bigtiff == "auto":
            # raw pyramid bound: 4/3 x main raster (+ slack); classic TIFF
            # offsets are u32
            est = self.shape[0] * self.shape[1] * self.dtype.itemsize
            bigtiff = est * 4 // 3 > 3_500_000_000
        self.big = bool(bigtiff)
        self._f = open(fn, "wb")
        if self.big:
            self._f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
        else:
            self._f.write(b"II" + struct.pack("<HI", 42, 0))
        self._levels = []
        self._new_level(self.shape, factor=1)

    # -- streaming ------------------------------------------------------------

    def _new_level(self, shape, factor):
        t = self.tile
        na = (shape[1] + t - 1) // t  # tiles across
        nd = (shape[0] + t - 1) // t
        self._levels.append({
            "shape": tuple(shape), "factor": factor,
            "offs": np.zeros(na * nd, "uint64"),
            "cnts": np.zeros(na * nd, "uint64"),
            "across": na, "down": nd,
        })

    def add_overview_level(self, factor):
        """Begin a mean-downsampled overview level; subsequent
        ``write_window(level=k)`` calls stream its tiles."""
        n, m = self.shape
        self._new_level((max(1, n // factor), max(1, m // factor)), factor)
        return len(self._levels) - 1

    def write_window(self, data, offset, level=0):
        """Write a tile-aligned window of ``level`` (row/col offsets must be
        multiples of the tile size; the window is padded at raster edges)."""
        lv = self._levels[level]
        t = self.tile
        i0, j0 = offset
        if i0 % t or j0 % t:
            raise ValueError("window offset %r not tile-aligned" % (offset,))
        data = np.asarray(data)
        n, m = lv["shape"]
        for ti in range(i0 // t, min((i0 + data.shape[0] + t - 1) // t,
                                     lv["down"])):
            for tj in range(j0 // t, min((j0 + data.shape[1] + t - 1) // t,
                                         lv["across"])):
                block = np.zeros((t, t), self.dtype)
                r0, c0 = ti * t - i0, tj * t - j0
                r1 = min(r0 + t, data.shape[0], n - i0)
                c1 = min(c0 + t, data.shape[1], m - j0)
                if r1 <= r0 or c1 <= c0:
                    continue
                if self.nodata is not None and self.dtype.kind == "f":
                    block[:] = self.nodata
                block[: r1 - r0, : c1 - c0] = data[r0: r1, c0: c1]
                raw = block.tobytes()
                if self.compress:
                    raw = zlib.compress(raw, 6)
                k = ti * lv["across"] + tj
                lv["offs"][k] = self._f.tell()
                lv["cnts"][k] = len(raw)
                self._f.write(raw)

    def build_overviews(self, factors, read_window, slab_bytes=32 << 20,
                        method="mean"):
        """Stream a 3^k-style pyramid: overview rows are downsampled with
        ``method`` (mean/average, nearest, bilinear, cubic — io.resample;
        the reference's rasterio Resampling surface) from full-width source
        slabs fetched via ``read_window(rows, cols)`` (a chunk-granular
        store read).  Peak memory is bounded by ``slab_bytes`` regardless
        of raster or factor size."""
        from .resample import downsample_rows

        t = self.tile
        n_src, m_src = self.shape
        for f in factors:
            lvl = self.add_overview_level(f)
            n, m = self._levels[lvl]["shape"]
            # overview rows per slab, a multiple of the tile height so
            # write_window stays tile-aligned
            rps = max(1, slab_bytes // (m_src * self.dtype.itemsize * f))
            # keep slabs tile-aligned (floor to a tile multiple, min one tile)
            rps = max(t, rps - rps % t)
            i0 = 0
            while i0 < n:
                nr = min(rps, n - i0)
                # full source width (not the trimmed m*f): the interpolating
                # kernels' edge clamp must match the in-core downsample(),
                # which sees remainder columns beyond m*f
                ov = downsample_rows(read_window, f, method, i0, i0 + nr,
                                     n_src, m_src)
                if self.nodata is not None:
                    ov = np.where(np.isnan(ov), self.nodata, ov)
                if i0 % t:
                    raise ValueError("slab rows must stay tile-aligned")
                self.write_window(ov, (i0, 0), level=lvl)
                i0 += nr

    # -- IFD serialization ----------------------------------------------------

    def _write_ifds(self):
        f = self._f
        vsz = 8 if self.big else 4
        ifd_offsets = []
        # serialize each level's IFD with its out-of-line payloads
        for li, lv in enumerate(self._levels):
            n, m = lv["shape"]
            entries = []  # (tag, typ, vals)
            if li > 0:
                entries.append((254, 4, [1]))  # reduced-resolution subfile
            entries.append((256, 4, [m]))
            entries.append((257, 4, [n]))
            entries.append((258, 3, [self.dtype.itemsize * 8]))
            entries.append((259, 3, [8 if self.compress else 1]))
            entries.append((262, 3, [1]))
            entries.append((277, 3, [1]))
            entries.append((322, 3, [self.tile]))
            entries.append((323, 3, [self.tile]))
            otyp = 16 if self.big else 4
            entries.append((324, otyp, lv["offs"]))
            entries.append((325, otyp, lv["cnts"]))
            entries.append((339, 3, [_FMT[self.dtype.kind]]))
            if li == 0 and self.transform is not None:
                a, b, c, d, e, fy = self.transform
                entries.append((33550, 12, [a, -e, 0.0]))
                entries.append((33922, 12, [0.0, 0.0, 0.0, c, fy, 0.0]))
                model = 1 if self.projected else 2
                geokey = [1, 1, 0, 3, 1024, 0, 1, model,
                          1025, 0, 1, 1,
                          (3072 if self.projected else 2048), 0, 1,
                          self.crs_code]
                entries.append((34735, 3, geokey))
            if li == 0 and self.nodata is not None:
                entries.append((42113, 2, repr(float(self.nodata))))
            entries.sort(key=lambda x: x[0])

            # out-of-line payloads first, recording their offsets
            payload_off = {}
            for tag, typ, vals in entries:
                code = {1: "B", 2: "c", 3: "H", 4: "I", 12: "d",
                        16: "Q"}[typ]
                if typ == 2:
                    raw = (vals if isinstance(vals, bytes)
                           else vals.encode("ascii")) + b"\0"
                else:
                    raw = struct.pack("<" + code * len(vals), *[
                        v.item() if hasattr(v, "item") else v for v in vals])
                if len(raw) > vsz:
                    if f.tell() % 2:
                        f.write(b"\0")
                    payload_off[tag] = f.tell()
                    f.write(raw)
            if f.tell() % 2:
                f.write(b"\0")
            ifd_offsets.append(f.tell())
            # entry count
            f.write(struct.pack("<Q" if self.big else "<H", len(entries)))
            for tag, typ, vals in entries:
                code = {1: "B", 2: "c", 3: "H", 4: "I", 12: "d",
                        16: "Q"}[typ]
                if typ == 2:
                    raw = (vals if isinstance(vals, bytes)
                           else vals.encode("ascii")) + b"\0"
                    cnt = len(raw)
                else:
                    raw = struct.pack("<" + code * len(vals), *[
                        v.item() if hasattr(v, "item") else v for v in vals])
                    cnt = len(vals)
                ent = struct.pack("<HHQ" if self.big else "<HHI", tag, typ,
                                  cnt)
                if len(raw) <= vsz:
                    ent += raw + b"\0" * (vsz - len(raw))
                else:
                    ent += struct.pack("<Q" if self.big else "<I",
                                       payload_off[tag])
                f.write(ent)
            # next-IFD pointer placeholder
            lv["_next_ptr_at"] = f.tell()
            f.write(b"\0" * vsz)

        # chain the IFDs and patch the header
        for li in range(len(self._levels) - 1):
            f.seek(self._levels[li]["_next_ptr_at"])
            f.write(struct.pack("<Q" if self.big else "<I",
                                ifd_offsets[li + 1]))
        f.seek(8 if self.big else 4)
        f.write(struct.pack("<Q" if self.big else "<I", ifd_offsets[0]))

    def close(self):
        if self._f is None:
            return
        self._write_ifds()
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
