"""pydem_tpu_torch's host-only modules against pydem_tpu's: the GeoTIFF
codec (incl. the LZW, PackBits and predictor decoders), the raw formats, the
tiled writer with overviews, the four resampling methods, the array store,
geometry, fixtures, the utils surface, profiling and debug.

These modules are copies, so everything is exact: files written by one
package are read by the other to equal arrays, and where both write, the
bytes are equal.  The compressed inputs come from a small TIFF encoder in
this file (LZW with growing code widths and table resets, PackBits,
horizontal and floating-point predictors), since neither package writes
those.
"""
import os
import struct

import numpy as np
import pytest
import torch

from pydem_tpu import fixtures as j_fixtures
from pydem_tpu import geometry as j_geometry
from pydem_tpu import utils as j_utils
from pydem_tpu.io import bigtiff as j_bigtiff
from pydem_tpu.io import geotiff as j_geotiff
from pydem_tpu.io import raw as j_raw
from pydem_tpu.io import resample as j_resample
from pydem_tpu.io import store as j_store
from pydem_tpu_torch import debug as t_debug
from pydem_tpu_torch import fixtures as t_fixtures
from pydem_tpu_torch import geometry as t_geometry
from pydem_tpu_torch import profiling as t_profiling
from pydem_tpu_torch import utils as t_utils
from pydem_tpu_torch.io import bigtiff as t_bigtiff
from pydem_tpu_torch.io import geotiff as t_geotiff
from pydem_tpu_torch.io import raw as t_raw
from pydem_tpu_torch.io import resample as t_resample
from pydem_tpu_torch.io import store as t_store

torch.set_num_threads(1)

TRANSFORM = (0.01, 0.0, -73.0, 0.0, -0.01, 46.0)


def _field(n=48, m=40, seed=0, dtype="float32"):
    rng = np.random.RandomState(seed)
    a = np.add.outer(np.arange(n), np.arange(m)) + rng.uniform(0, 3, (n, m))
    return a.astype(dtype)


def _bytes(fn):
    with open(fn, "rb") as f:
        return f.read()


def _same_grid(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype
    assert tuple(a.transform) == tuple(b.transform)
    assert (a.crs_code, a.nodata, a.projected, a.ellipsoid, a.shape) == \
        (b.crs_code, b.nodata, b.projected, b.ellipsoid, b.shape)
    assert tuple(a.bounds) == tuple(b.bounds)


# -- a small TIFF encoder for the compressed cases --------------------------

def _lzw_encode(buf):
    """TIFF LZW (MSB-first codes, early change), mirroring the decoder's
    code-width rule: after k data codes since the last clear the decoder's
    table holds 258 + k - 1 entries."""
    out, bits, nbits = bytearray(), 0, 0

    def emit(code, width):
        nonlocal bits, nbits
        bits = (bits << width) | code
        nbits += width
        while nbits >= 8:
            out.append((bits >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table, width, k = None, 9, 0
    w = b""
    for i in range(len(buf) + 1):
        if table is None:
            emit(256, width)
            table, width, k = {bytes([c]): c for c in range(256)}, 9, 0
        c = buf[i: i + 1]
        if c and w + c in table:
            w += c
            continue
        if w:
            emit(table[w], width)
            k += 1
            if 258 + k - 1 >= (1 << width) - 1 and width < 12:
                width += 1
        if c:
            table[w + c] = 258 + len(table) - 256
            w = c
            if len(table) - 256 + 258 >= 4093:
                emit(table[w], width)
                w = b""
                emit(256, width)
                table, width, k = {bytes([x]): x for x in range(256)}, 9, 0
    emit(257, width)
    if nbits:
        out.append((bits << (8 - nbits)) & 0xFF)
    return bytes(out)


def _packbits_encode(buf):
    out, i, n = bytearray(), 0, len(buf)
    while i < n:
        run = 1
        while i + run < n and run < 128 and buf[i + run] == buf[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, buf[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and buf[j] == buf[j + 1] == buf[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + buf[i:j]
        i = j
    return bytes(out)


def _predict(data, predictor):
    if predictor == 2:  # horizontal differencing, wrapping
        out = data.copy()
        out[:, 1:] = data[:, 1:] - data[:, :-1]
        return out.tobytes()
    if predictor == 3:  # floating-point: byte planes, then byte differences
        h, w = data.shape
        nb = data.dtype.itemsize
        be = data.astype(data.dtype.newbyteorder(">")).view(np.uint8)
        planes = np.moveaxis(be.reshape(h, w, nb), 2, 1).reshape(h, nb * w)
        out = planes.copy()
        out[:, 1:] = planes[:, 1:] - planes[:, :-1]
        return out.tobytes()
    return data.tobytes()


def _write_tiff(fn, data, comp=1, predictor=1, rows_per_strip=16):
    """Classic little-endian striped TIFF of one band."""
    h, w = data.shape
    enc = {1: bytes, 5: _lzw_encode, 32773: _packbits_encode}[comp]
    strips = [enc(_predict(np.ascontiguousarray(data[r: r + rows_per_strip]),
                           predictor))
              for r in range(0, h, rows_per_strip)]
    fmt = {"u": 1, "i": 2, "f": 3}[data.dtype.kind]
    n = len(strips)
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1,
                                               data.dtype.itemsize * 8),
               (259, 3, 1, comp), (262, 3, 1, 1), (273, 4, n, None),
               (277, 3, 1, 1), (278, 3, 1, rows_per_strip),
               (279, 4, n, None), (317, 3, 1, predictor), (339, 3, 1, fmt)]
    ifd_size = 2 + 12 * len(entries) + 4
    arrays_off = 8 + ifd_size
    data_off = arrays_off + (8 * n if n > 1 else 0)
    offs, pos = [], data_off
    for s in strips:
        offs.append(pos)
        pos += len(s)
    body = struct.pack("<2sHI", b"II", 42, 8) + struct.pack("<H",
                                                            len(entries))
    for tag, typ, cnt, val in entries:
        if val is None:
            vals = offs if tag == 273 else [len(s) for s in strips]
            val = vals[0] if n == 1 else arrays_off + (0 if tag == 273
                                                       else 4 * n)
        body += struct.pack("<HHI", tag, typ, cnt)
        body += struct.pack("<HH", val, 0) if typ == 3 else struct.pack("<I",
                                                                        val)
    body += struct.pack("<I", 0)
    if n > 1:
        body += struct.pack("<%dI" % n, *offs)
        body += struct.pack("<%dI" % n, *[len(s) for s in strips])
    with open(fn, "wb") as f:
        f.write(body + b"".join(strips))


@pytest.mark.parametrize("comp,predictor,dtype", [
    (1, 1, "float32"), (5, 1, "float32"), (5, 1, "uint8"), (5, 2, "int16"),
    (5, 3, "float32"), (32773, 1, "int16"), (32773, 1, "uint8"),
    (1, 2, "uint16"), (1, 3, "float64"),
])
def test_compressed_tiffs_decode_alike(tmp_path, comp, predictor, dtype):
    """LZW (widths up to 12 bits, table resets), PackBits and both
    predictors: each package's reader gives back the encoded array."""
    if dtype == "uint8":  # long runs and repeats: short codes, replicate runs
        data = (np.add.outer(np.arange(64), np.arange(96)) // 9 % 7).astype(
            dtype)
    else:
        data = (_field(64, 96, seed=comp + predictor, dtype="float64")
                * 37).astype(dtype)
    fn = str(tmp_path / "c.tif")
    _write_tiff(fn, data, comp, predictor)
    got, want = t_geotiff.read_geotiff(fn), j_geotiff.read_geotiff(fn)
    np.testing.assert_array_equal(got.data, data)
    _same_grid(got, want)


def test_decoders_are_the_same_functions_of_their_input():
    rng = np.random.RandomState(3)
    raw = rng.randint(0, 4, 40000).astype(np.uint8).tobytes()
    lzw, pb = _lzw_encode(raw), _packbits_encode(raw)
    assert len(lzw) < len(raw)  # 40 kB at 2 bits of entropy: widths grew
    assert t_geotiff._lzw_decode(lzw) == j_geotiff._lzw_decode(lzw) == raw
    assert (t_geotiff._packbits_decode(pb) == j_geotiff._packbits_decode(pb)
            == raw)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype,nodata,projected", [
    ("float32", -9999, False), ("float64", None, False),
    ("int16", -32768, False), ("float32", -9999.0, True),
])
def test_geotiff_written_by_one_read_by_the_other(tmp_path, compress, dtype,
                                                  nodata, projected):
    data = _field(dtype=dtype)
    kw = dict(nodata=nodata, compress=compress, projected=projected,
              crs_code=32613 if projected else 4326)
    tr = (30.0, 0.0, 5e5, 0.0, -30.0, 4.4e6) if projected else TRANSFORM
    fn_t, fn_j = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    t_geotiff.write_geotiff(fn_t, data, tr, **kw)
    j_geotiff.write_geotiff(fn_j, data, tr, **kw)
    assert _bytes(fn_t) == _bytes(fn_j)
    got, want = j_geotiff.read_geotiff(fn_t), t_geotiff.read_geotiff(fn_j)
    np.testing.assert_array_equal(got.data, data)
    _same_grid(got, want)
    head = t_geotiff.read_geotiff(fn_j, header_only=True)
    assert head.data is None and head.shape == data.shape
    with pytest.raises(IndexError):
        t_geotiff.read_geotiff(fn_j, ifd_index=1)
    for a, b in zip(t_geotiff.GeoTiff(data, tr).pixel_scales(),
                    j_geotiff.GeoTiff(data, tr).pixel_scales()):
        np.testing.assert_array_equal(a, b)


def test_read_kwargs_alike(tmp_path):
    data = _field().astype("int16")
    data[3, 4] = -32768
    fn = str(tmp_path / "k.tif")
    j_geotiff.write_geotiff(fn, data, TRANSFORM, nodata=-32768)
    for reader_t, reader_j in ((t_geotiff.read_geotiff_kwargs,
                                j_geotiff.read_geotiff_kwargs),
                               (t_raw.read_raster_kwargs,
                                j_raw.read_raster_kwargs)):
        got, want = reader_t(fn), reader_j(fn)
        assert sorted(got) == sorted(want)
        # only read_raster_kwargs masks an integer raster's nodata
        assert np.isnan(got["elev"][3, 4]) == (reader_t
                                                is t_raw.read_raster_kwargs)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="Not a TIFF"):
        bad = str(tmp_path / "bad.tif")
        with open(bad, "wb") as f:
            f.write(b"nope" * 4)
        t_geotiff.read_geotiff(bad)


def test_hgt_and_flt_read_alike(tmp_path):
    rng = np.random.RandomState(0)
    hgt = (rng.rand(121, 121) * 1000).astype(">i2")
    hgt[0, 0] = -32768
    fn = str(tmp_path / "N40W105.hgt")
    hgt.tofile(fn)
    got, want = t_raw.read_raster(fn), j_raw.read_raster(fn)
    np.testing.assert_array_equal(got.data, hgt.astype("=i2"))
    _same_grid(got, want)
    _same_grid(t_raw.read_hgt(fn), j_raw.read_hgt(fn))
    assert t_raw.read_raster(fn, header_only=True).shape == (121, 121)

    flt = np.arange(12, dtype="<f4").reshape(3, 4)
    fn = str(tmp_path / "grid.flt")
    flt.tofile(fn)
    with open(str(tmp_path / "grid.hdr"), "w") as f:
        f.write("ncols 4\nnrows 3\nxllcorner 500000\nyllcorner 4400000\n"
                "cellsize 30\nNODATA_value -9999\nbyteorder LSBFIRST\n")
    got, want = t_raw.read_flt(fn), j_raw.read_flt(fn)
    np.testing.assert_array_equal(got.data, flt)
    _same_grid(got, want)
    assert got.projected and tuple(got.transform)[0] == 30.0


@pytest.mark.parametrize("method", ["mean", "average", "nearest", "bilinear",
                                    "cubic"])
def test_resampling_methods_alike(method):
    """The four methods (and the ``average`` alias), with NaN taps left as
    the JAX package leaves them, whole and streamed by rows."""
    data = _field(81, 60, seed=4, dtype="float64")
    data[5:9, 7:11] = np.nan
    for fac in (2, 3, 9):
        got = t_resample.downsample(data, fac, method)
        want = j_resample.downsample(data, fac, method)
        np.testing.assert_array_equal(got, want)

        def rw(rows, cols):
            return data[rows[0]: rows[1], cols[0]: cols[1]]

        n_out = data.shape[0] // fac
        args = (fac, method, 1, n_out - 1, *data.shape)
        np.testing.assert_array_equal(
            t_resample.downsample_rows(rw, *args),
            j_resample.downsample_rows(rw, *args))
    with pytest.raises(ValueError):
        t_resample.downsample(data, 3, "lanczos")


@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("method", ["mean", "nearest", "bilinear", "cubic"])
def test_tiled_writer_and_overviews_alike(tmp_path, bigtiff, method):
    data = _field(100, 70, seed=5)
    data[10:20, 30:40] = np.nan
    files = {}
    for name, mod in (("t", t_bigtiff), ("j", j_bigtiff)):
        fn = str(tmp_path / (name + ".tif"))
        with mod.TiledTiffWriter(fn, data.shape, "float32",
                                 transform=TRANSFORM, nodata=-9999.0, tile=32,
                                 bigtiff=bigtiff) as w:
            for i0 in range(0, 100, 32):
                band = data[i0: i0 + 32]
                w.write_window(np.where(np.isnan(band), np.float32(-9999),
                                        band), (i0, 0))
            w.build_overviews(
                [3, 9], lambda r, c: data[r[0]: r[1], c[0]: c[1]],
                method=method)
        files[name] = fn
    assert _bytes(files["t"]) == _bytes(files["j"])
    for k, fac in enumerate((1, 3, 9)):
        got = j_geotiff.read_geotiff(files["t"], ifd_index=k)
        want = t_geotiff.read_geotiff(files["j"], ifd_index=k)
        _same_grid(got, want)
        assert got.shape == (100 // fac, 70 // fac)
    base = t_geotiff.read_geotiff(files["t"])
    np.testing.assert_array_equal(
        base.data, np.where(np.isnan(data), np.float32(-9999), data))
    assert tuple(base.transform) == TRANSFORM and base.nodata == -9999.0


def test_array_store_windows_alike(tmp_path):
    """Chunked windowed writes and reads: the chunk files are the same
    bytes, and each package reads the other's store."""
    data = _field(70, 50, seed=6, dtype="float64")
    stores = {}
    for name, mod in (("t", t_store), ("j", j_store)):
        s = mod.ArrayStore(str(tmp_path / name))
        s.create("a", (70, 50), "float64", chunks=(32, 16), fill=np.nan)
        s.write_window("a", data[:40, :30], (0, 0))
        s.write_window("a", data[33:, 20:], (33, 20))
        s["mask"] = data > 40
        s["small"] = np.arange(6, dtype="int32").reshape(2, 3)
        stores[name] = s
    for root, _dirs, fns in os.walk(str(tmp_path / "j")):
        for fn in fns:
            other = os.path.join(root.replace(str(tmp_path / "j"),
                                              str(tmp_path / "t")), fn)
            assert _bytes(os.path.join(root, fn)) == _bytes(other), fn
    cross_t = t_store.ArrayStore(str(tmp_path / "j"))
    cross_j = j_store.ArrayStore(str(tmp_path / "t"))
    assert sorted(cross_t.names()) == sorted(cross_j.names()) == \
        ["a", "mask", "small"]
    want = np.full((70, 50), np.nan)
    want[:40, :30] = data[:40, :30]
    want[33:, 20:] = data[33:, 20:]
    for s in (cross_t, cross_j):
        np.testing.assert_array_equal(s["a"], want)
        np.testing.assert_array_equal(s["mask"], data > 40)
        assert s["small"].dtype == np.int32
        np.testing.assert_array_equal(
            s.read_window("a", (30, 45), (10, 40)), want[30:45, 10:40])
        # a window past the array's edge reads as fill
        out = s.read_window("a", (60, 80), (40, 60))
        np.testing.assert_array_equal(out[:10, :10], want[60:, 40:])
        assert np.isnan(out[10:, :]).all() and np.isnan(out[:, 10:]).all()
    assert "a" in cross_t and "nothing" not in cross_t
    cross_t.delete("small")
    assert "small" not in j_store.ArrayStore(str(tmp_path / "j"))


def test_geometry_alike():
    lat = np.linspace(35, 47, 9)
    for f in ("WGS-84", "GRS-80"):
        np.testing.assert_array_equal(
            t_geometry.vincenty_inverse(lat, -73.0, lat + 0.01, -72.99,
                                        ellipsoid=f),
            j_geometry.vincenty_inverse(lat, -73.0, lat + 0.01, -72.99,
                                        ellipsoid=f))
    for projected in (False, True):
        for a, b in zip(
                t_geometry.pixel_scales(TRANSFORM, 33, projected=projected),
                j_geometry.pixel_scales(TRANSFORM, 33, projected=projected)):
            np.testing.assert_array_equal(a, b)
    coords = (45.0, -73.0, 46.0, -72.0)
    assert t_geometry.get_fn_from_coords(coords, "uca") == \
        j_geometry.get_fn_from_coords(coords, "uca")
    assert t_geometry.mk_transform(46, -73, -0.01, 0.01) == \
        j_geometry.mk_transform(46, -73, -0.01, 0.01)
    assert t_geometry.ELLIPSOIDS == j_geometry.ELLIPSOIDS


@pytest.mark.parametrize("case", [0, 5, 9, 13, 17, 18, 23, 24, 26, 28, 29,
                                  30, 31, 32, 33, 34])
def test_fixtures_alike(case):
    for got, want in zip(t_fixtures.get_test_case(case, 24),
                         j_fixtures.get_test_case(case, 24)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_utils_surface_alike(tmp_path):
    assert t_utils.__all__ == j_utils.__all__
    region = np.zeros((9, 9), bool)
    region[2:6, 3:8] = True
    src = np.zeros_like(region)
    src[2, 3] = True
    I = np.flatnonzero(region)
    for name, args in (("get_adjacent_index", (I, region.shape, region.size)),
                       ("get_border_index", (I, region.shape, region.size)),
                       ("get_border_mask", (region,)),
                       ("get_distance", (region, src)),
                       ("find_centroid", (region,)),
                       ("sortrows", (np.array([[3, 1], [1, 2], [3, 0]]),)),
                       ("grow_obj", ((slice(2, 6), slice(3, 8)), (9, 9))),
                       ("make_slice", (5, 2)), ("grow_slice", (slice(0, 3),
                                                               9))):
        got = getattr(t_utils, name)(*args)
        want = getattr(j_utils, name)(*args)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name
    fn = t_utils.save_raster(str(tmp_path / "r.tif"), _field(), crs=4326,
                             transform=TRANSFORM)
    _same_grid(t_utils.read_raster(fn), j_utils.read_raster(fn))
    got = t_utils.mk_dx_dy_from_geotif_layer(t_utils.read_raster(fn))
    want = j_utils.mk_dx_dy_from_geotif_layer(j_utils.read_raster(fn))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert t_utils.get_fn(t_utils.read_raster(fn), "twi") == \
        j_utils.get_fn(j_utils.read_raster(fn), "twi")
    kw = t_utils.dem_processor_from_raster_kwargs(fn)
    assert kw["elev"].shape == (48, 40)
    with pytest.raises(ValueError, match="transform"):
        t_utils.save_raster(str(tmp_path / "x.tif"), _field())


def test_profiling_on_the_cpu(tmp_path):
    """StageTimer accumulates host seconds a stage; each stage is a span:
    under a recording it is a record of its own, with the spans opened
    inside it as its children, and a ``pydem::`` range in a
    ``torch.profiler`` trace."""
    import json

    from torch.profiler import ProfilerActivity, profile

    timer = t_profiling.StageTimer()
    with timer.stage("a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_profiling.recording("cpu") as rec:
            with timer.stage("a"):
                with t_profiling.span("x"):
                    assert float((torch.ones(8) * 2).sum()) == 16.0
    assert list(timer.report()) == ["a"] and timer.report()["a"] >= 0
    timer.dump(str(tmp_path / "t.json"))
    with open(str(tmp_path / "t.json")) as f:
        assert list(json.load(f)) == ["a"]
    (record,) = rec.records()
    assert record["parents"] == {"a": None, "x": "a"}
    assert 0 <= record["spans"]["x"] <= record["spans"]["a"]
    assert record["spans"]["a"] <= 1e3 * timer.report()["a"]
    names = {e.name for e in prof.events()}
    assert {"pydem::a", "pydem::x"} <= names


def test_debug_plots_build():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from pydem_tpu_torch.api import DEMProcessor

    elev = t_fixtures.get_test_case(33, 16)[0]
    dp = DEMProcessor(elev=elev, device="cpu")
    dp.calc_twi()
    W = np.zeros((8, 16, 16))
    W[0, :, :-1] = 1.0
    assert t_debug.plot_connectivity(W, elev) is not None
    fig = t_debug.plot_fields(dp)
    assert len(fig.axes) >= 5
    matplotlib.pyplot.close("all")
