"""Self-contained GeoTIFF reader/writer (no GDAL/rasterio dependency).

Replaces the reference's rasterio usage (``utils.py:43-79,
127-205``) with a minimal pure-numpy TIFF codec sufficient for DEM work:

- read: classic TIFF, little/big endian, striped or tiled, uncompressed /
  Deflate / LZW / PackBits, 8-64-bit integer & float samples, horizontal and
  floating-point predictors, GeoTIFF tags (pixel scale, tiepoint, geokey
  directory), GDAL nodata.
- write: single-band striped GeoTIFF, optional Deflate, with the WGS84
  geokeys that rasterio/GDAL produce for EPSG:4326 rasters.

The bundled reference test tile (float64, single strip) round-trips exactly.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/io/geotiff.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..geometry import pixel_scales

# TIFF type sizes and struct codes
_TYPES = {
    1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8),
}

T_WIDTH, T_HEIGHT, T_BITS, T_COMP = 256, 257, 258, 259
T_PHOTO, T_STRIP_OFF, T_SPP, T_ROWS_PER_STRIP, T_STRIP_CNT = 262, 273, 277, 278, 279
T_PLANAR, T_PREDICTOR = 284, 317
T_TILE_W, T_TILE_H, T_TILE_OFF, T_TILE_CNT = 322, 323, 324, 325
T_SAMPLE_FORMAT = 339
T_PIXEL_SCALE, T_TIEPOINT = 33550, 33922
T_GEO_KEYS, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113

# Geographic-CS (geokey 2048) and ellipsoid (geokey 2056) EPSG codes →
# geometry.ELLIPSOIDS names.  The reference picks the geodesic ellipsoid
# from the raster CRS WKT's SPHEROID/ELLIPSOID name (utils.py:139-151);
# a from-scratch GeoTIFF parser sees EPSG codes instead, so the mapping is
# by code.  Unlisted codes fall back to WGS-84 with a warning.
_GCS_ELLIPSOID = {
    4326: "WGS-84", 4322: "WGS-72", 4269: "GRS-80", 4258: "GRS-80",
    4283: "GRS-80", 4617: "GRS-80", 4277: "Airy-(1830)",
    4230: "Intl-1924", 4267: "Clarke-(1866)", 4222: "Clarke-(1880)",
}
_ELLIPSOID_CODE = {
    7030: "WGS-84", 7019: "GRS-80", 7001: "Airy-(1830)",
    7022: "Intl-1924", 7008: "Clarke-(1866)", 7012: "Clarke-(1880)",
    7034: "Clarke-(1880)", 7043: "WGS-72",
}


def _ellipsoid_from_geokeys(geo_keys):
    """Geodesic ellipsoid name from parsed geokeys (dict key → value).

    Precedence: explicit GeogEllipsoidGeoKey (2056), then the geographic CS
    code (2048).  Unknown codes warn and fall back to WGS-84 — the silent
    default the reference only reaches when the WKT has no SPHEROID entry."""
    import warnings

    from ..geometry import ELLIPSOIDS

    code = geo_keys.get(2056)
    if code is not None:
        name = _ELLIPSOID_CODE.get(code)
        if name in ELLIPSOIDS:
            return name
        if code != 32767:  # user-defined sentinel: fall through to the GCS
            warnings.warn("Unknown GeoTIFF ellipsoid code %r; assuming "
                          "WGS-84 pixel scales" % (code,))
            return "WGS-84"
    code = geo_keys.get(2048)
    if code is not None:
        name = _GCS_ELLIPSOID.get(code)
        if name in ELLIPSOIDS:
            return name
        warnings.warn("Unknown geographic CS code %r; assuming WGS-84 "
                      "pixel scales" % (code,))
    return "WGS-84"


class GeoTiff:
    """Parsed single-band GeoTIFF."""

    def __init__(self, data, transform, crs_code=4326, nodata=None,
                 projected=False, ellipsoid="WGS-84", shape=None):
        self.data = data
        self._shape = shape if data is None else data.shape
        # GDAL-style affine 6-tuple (a, b, c, d, e, f):
        # x = a*col + b*row + c ; y = d*col + e*row + f
        self.transform = transform
        self.crs_code = crs_code
        self.nodata = nodata
        self.projected = projected
        self.ellipsoid = ellipsoid

    @property
    def shape(self):
        return self._shape

    @property
    def bounds(self):
        """(left, bottom, right, top)."""
        a, b, c, d, e, f = self.transform
        n, m = self.shape
        xs = [c, a * m + c]
        ys = [f, e * n + f]
        return (min(xs), min(ys), max(xs), max(ys))

    def pixel_scales(self):
        return pixel_scales(self.transform, self.shape[0],
                            projected=self.projected, ellipsoid=self.ellipsoid)


def _lzw_decode(buf):
    """TIFF-variant LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    code_len = 9
    prev = None
    bitbuf = 0
    nbits = 0
    pos = 0
    n = len(buf)
    while True:
        while nbits < code_len and pos < n:
            bitbuf = (bitbuf << 8) | buf[pos]
            pos += 1
            nbits += 8
        if nbits < code_len:
            break
        code = (bitbuf >> (nbits - code_len)) & ((1 << code_len) - 1)
        nbits -= code_len
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            code_len = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) >= (1 << code_len) - 1 and code_len < 12:
            code_len += 1
    return bytes(out)


def _packbits_decode(buf):
    out = bytearray()
    i = 0
    n = len(buf)
    while i < n:
        c = buf[i]
        i += 1
        if c < 128:
            out += buf[i: i + c + 1]
            i += c + 1
        elif c > 128:
            out += buf[i: i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _undo_predictor(arr, predictor, dtype):
    if predictor == 2:  # horizontal differencing
        np.cumsum(arr, axis=-1, dtype=arr.dtype, out=arr)
    elif predictor == 3:  # floating-point byte-split predictor
        h, w = arr.shape[:2]
        nb = dtype.itemsize
        raw = arr.view(np.uint8).reshape(h, w * nb)
        raw = np.cumsum(raw.astype(np.int64), axis=-1).astype(np.uint8)
        # bytes are split plane-wise, big-endian
        planes = raw.reshape(h, nb, w)
        inter = np.moveaxis(planes, 1, 2).reshape(h, w * nb)
        arr = inter.view(np.dtype(dtype).newbyteorder(">")).reshape(h, w)
        return arr.astype(dtype)
    return arr


def _parse_ifd(d, bo, ifd_off, big):
    """One IFD (classic or BigTIFF) → (tags dict, next-IFD offset)."""
    tags = {}
    if big:
        n = struct.unpack(bo + "Q", d[ifd_off: ifd_off + 8])[0]
        base, esz, vsz, vfmt = ifd_off + 8, 20, 8, "Q"
        cfmt = "HHQ"
    else:
        n = struct.unpack(bo + "H", d[ifd_off: ifd_off + 2])[0]
        base, esz, vsz, vfmt = ifd_off + 2, 12, 4, "I"
        cfmt = "HHI"
    for i in range(n):
        e = d[base + esz * i: base + esz * (i + 1)]
        tag, typ, cnt = struct.unpack(bo + cfmt, e[: esz - vsz])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        total = size * cnt
        if total <= vsz:
            raw = e[esz - vsz: esz - vsz + total]
        else:
            off = struct.unpack(bo + vfmt, e[esz - vsz: esz])[0]
            raw = d[off: off + total]
        if typ == 2:
            vals = raw.rstrip(b"\0").decode("ascii", "replace")
        elif typ in (5, 10):
            pairs = struct.unpack(bo + code[0] * 2 * cnt, raw)
            vals = [pairs[2 * k] / pairs[2 * k + 1] for k in range(cnt)]
        else:
            vals = list(struct.unpack(bo + code * cnt, raw))
        tags[tag] = vals
    nxt = struct.unpack(bo + vfmt,
                        d[base + esz * n: base + esz * n + vsz])[0]
    return tags, nxt


def read_geotiff(fn, header_only=False, ifd_index=0):
    """Read band 1 of a GeoTIFF into a :class:`GeoTiff`.

    Classic and BigTIFF (version 43) layouts are supported.
    ``header_only=True`` parses tags only (shape/transform/CRS/nodata) and
    leaves ``data`` as None — O(header) work, used by the bounded-memory
    tile-grid discovery.  ``ifd_index`` selects subsequent IFDs (embedded
    overview levels); IndexError if absent."""
    with open(fn, "rb") as f:
        d = f.read()
    if d[:2] == b"II":
        bo = "<"
    elif d[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("Not a TIFF file: %r" % fn)
    magic = struct.unpack(bo + "H", d[2:4])[0]
    if magic == 42:
        big = False
        ifd_off = struct.unpack(bo + "I", d[4:8])[0]
    elif magic == 43:
        big = True
        offsize, zero = struct.unpack(bo + "HH", d[4:8])
        if offsize != 8 or zero != 0:
            raise ValueError("Malformed BigTIFF header")
        ifd_off = struct.unpack(bo + "Q", d[8:16])[0]
    else:
        raise ValueError("Unsupported TIFF magic %d" % magic)

    tags, nxt = _parse_ifd(d, bo, ifd_off, big)
    for _ in range(ifd_index):
        if not nxt:
            raise IndexError("TIFF has no IFD index %d" % ifd_index)
        tags, nxt = _parse_ifd(d, bo, nxt, big)

    def tag1(t, default=None):
        v = tags.get(t)
        return default if v is None else (v[0] if isinstance(v, list) else v)

    width = tag1(T_WIDTH)
    height = tag1(T_HEIGHT)
    bits = tag1(T_BITS, 8)
    comp = tag1(T_COMP, 1)
    fmt = tag1(T_SAMPLE_FORMAT, 1)
    spp = tag1(T_SPP, 1)
    predictor = tag1(T_PREDICTOR, 1)
    if spp != 1:
        raise ValueError("Only single-band rasters supported (got %d)" % spp)

    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    dtype = np.dtype(bo + kind + str(bits // 8))

    def decode(chunk):
        if comp == 1:
            return chunk
        if comp in (8, 32946):
            return zlib.decompress(chunk)
        if comp == 5:
            return _lzw_decode(chunk)
        if comp == 32773:
            return _packbits_decode(chunk)
        raise ValueError("Unsupported TIFF compression %d" % comp)

    out = None
    if header_only:
        pass
    elif T_TILE_OFF in tags:
        out = np.zeros((height, width), dtype)
        tw, th = tag1(T_TILE_W), tag1(T_TILE_H)
        offs, cnts = tags[T_TILE_OFF], tags[T_TILE_CNT]
        tiles_across = (width + tw - 1) // tw
        for k, (o, c) in enumerate(zip(offs, cnts)):
            ti, tj = divmod(k, tiles_across)
            block = np.frombuffer(decode(d[o: o + c]), dtype).reshape(th, tw)
            block = _undo_predictor(block.copy(), predictor, dtype)
            i0, j0 = ti * th, tj * tw
            out[i0: i0 + th, j0: j0 + tw] = block[: height - i0, : width - j0]
    else:
        out = np.zeros((height, width), dtype)
        rps = tag1(T_ROWS_PER_STRIP, height)
        offs, cnts = tags[T_STRIP_OFF], tags[T_STRIP_CNT]
        row = 0
        for o, c in zip(offs, cnts):
            nrow = min(rps, height - row)
            block = np.frombuffer(decode(d[o: o + c])[: nrow * width * dtype.itemsize],
                                  dtype).reshape(nrow, width)
            block = _undo_predictor(block.copy(), predictor, dtype)
            out[row: row + nrow] = block
            row += nrow

    if out is not None:
        out = out.astype(out.dtype.newbyteorder("="))

    # geo transform
    transform = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    if T_PIXEL_SCALE in tags and T_TIEPOINT in tags:
        sx, sy = tags[T_PIXEL_SCALE][0], tags[T_PIXEL_SCALE][1]
        tp = tags[T_TIEPOINT]
        # tiepoint: (i, j, k, x, y, z) raster->model
        i, j = tp[0], tp[1]
        x, y = tp[3], tp[4]
        transform = (sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)

    # geokeys: model type + CS code + geodesic ellipsoid
    crs_code = 4326
    projected = False
    geo_keys = {}
    gk = tags.get(T_GEO_KEYS)
    if gk:
        nkeys = gk[3]
        for k in range(nkeys):
            key, loc, cnt_, val = gk[4 + 4 * k: 8 + 4 * k]
            if loc == 0:
                geo_keys[key] = val
        projected = geo_keys.get(1024) == 1
        crs_code = geo_keys.get(3072 if projected else 2048, crs_code)
    # projected rasters use constant pixel scales; the ellipsoid only
    # matters (and only then can meaningfully warn) for geographic ones
    ellipsoid = "WGS-84" if projected else _ellipsoid_from_geokeys(geo_keys)

    nodata = None
    if T_GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[T_GDAL_NODATA]).strip())
        except ValueError:
            pass

    return GeoTiff(out, transform, crs_code=crs_code, nodata=nodata,
                   projected=projected, ellipsoid=ellipsoid,
                   shape=(height, width))


def write_geotiff(fn, data, transform, crs_code=4326, nodata=None,
                  compress=False, projected=False):
    """Write a single-band striped (Geo)TIFF.

    ``projected=True`` writes a projected-CRS key directory
    (ProjectedCSTypeGeoKey = ``crs_code``, linear meters) instead of the
    geographic one, so projected inputs re-export with their CRS intact —
    the rasterio profile pass-through of the reference (utils.py:61-79)."""
    data = np.ascontiguousarray(data)
    height, width = data.shape
    dt = data.dtype
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8

    payload = data.astype(dt.newbyteorder("<")).tobytes()
    comp = 1
    if compress:
        payload = zlib.compress(payload, 6)
        comp = 8

    a, b, c, d_, e, f = transform
    pixel_scale = (a, -e, 0.0)
    tiepoint = (0.0, 0.0, 0.0, c, f, 0.0)
    if projected:
        # minimal projected key directory (matches GDAL's EPSG:<code> output)
        geokeys = [1, 1, 0, 4,
                   1024, 0, 1, 1,     # model type: projected
                   1025, 0, 1, 1,     # raster type: pixel-is-area
                   3072, 0, 1, int(crs_code),  # projected CS
                   3076, 0, 1, 9001]  # linear unit: metre
    else:
        # minimal geographic key directory (matches GDAL's EPSG:4326 output)
        geokeys = [1, 1, 0, 4,
                   1024, 0, 1, 2,     # model type: geographic
                   1025, 0, 1, 1,     # raster type: pixel-is-area
                   2048, 0, 1, int(crs_code),  # geographic CS
                   2054, 0, 1, 9102]  # angular unit: degree

    entries = []  # (tag, type, count, values)
    entries.append((T_WIDTH, 3, 1, [width]))
    entries.append((T_HEIGHT, 3, 1, [height]))
    entries.append((T_BITS, 3, 1, [bits]))
    entries.append((T_COMP, 3, 1, [comp]))
    entries.append((T_PHOTO, 3, 1, [1]))
    entries.append((T_STRIP_OFF, 4, 1, [0]))  # patched later
    entries.append((T_SPP, 3, 1, [1]))
    entries.append((T_ROWS_PER_STRIP, 3, 1, [height]))
    entries.append((T_STRIP_CNT, 4, 1, [len(payload)]))
    entries.append((T_PLANAR, 3, 1, [1]))
    entries.append((T_SAMPLE_FORMAT, 3, 1, [fmt]))
    entries.append((T_PIXEL_SCALE, 12, 3, list(pixel_scale)))
    entries.append((T_TIEPOINT, 12, 6, list(tiepoint)))
    entries.append((T_GEO_KEYS, 3, len(geokeys), geokeys))
    if nodata is not None:
        s = (repr(float(nodata)) + "\0").encode()
        entries.append((T_GDAL_NODATA, 2, len(s), s))
    entries.sort(key=lambda t: t[0])

    # layout: header(8) + IFD + extra data + payload
    nent = len(entries)
    ifd_size = 2 + nent * 12 + 4
    extra_off = 8 + ifd_size
    extra = bytearray()

    def pack_values(typ, cnt, vals):
        code, size = _TYPES[typ]
        if typ == 2:
            return bytes(vals)
        return struct.pack("<" + code * cnt, *vals)

    strip_off_pos = None
    body = bytearray()
    body += struct.pack("<H", nent)
    for tag, typ, cnt, vals in entries:
        code, size = _TYPES[typ]
        raw = pack_values(typ, cnt, vals)
        body += struct.pack("<HHI", tag, typ, cnt)
        if tag == T_STRIP_OFF:
            strip_off_pos = 8 + len(body)
            body += struct.pack("<I", 0)
        elif len(raw) <= 4:
            body += raw.ljust(4, b"\0")
        else:
            body += struct.pack("<I", extra_off + len(extra))
            extra += raw
    body += struct.pack("<I", 0)  # next IFD

    data_off = extra_off + len(extra)
    out = bytearray()
    out += b"II" + struct.pack("<HI", 42, 8)
    out += body
    out += extra
    out += payload
    struct.pack_into("<I", out, strip_off_pos, data_off)
    with open(fn, "wb") as fh:
        fh.write(bytes(out))


def read_geotiff_kwargs(fn):
    """File → DEMProcessor constructor kwargs
    (semantics of utils.py:46-51)."""
    g = read_geotiff(fn)
    dX, dY, dX2, dY2 = g.pixel_scales()
    return dict(elev=g.data, dX=dX, dY=dY, dX2=dX2, dY2=dY2,
                bounds=list(g.bounds), transform=list(g.transform))
