"""pydem_tpu_torch.ProcessManager on the CPU (float64): the cases of
``tests/test_manager.py`` and ``tests/test_export_streaming.py`` on the port,
the port's manager against the JAX package's on the same tiles, and the
golden comparison of ``deploy/golden_check.py`` (fixture 33, 64², 2×2 tiles,
overlap 2, default options) against ``deploy/goldens/*.tif``.

Tolerances: store arrays of integer and bool type exact; ``elev`` exact;
``aspect``, ``slope``, ``uca``, ``twi`` ``decimal=10`` against the JAX
manager, the uca counted in pixels (with geodesic pixel sizes its values are
~5e7 m², where one float64 ulp is already 7e-9; it is divided by the
smallest pixel area first); the exported GeoTIFFs byte for byte against the
goldens (which the JAX package wrote on the CPU in float64).  The tile
writer is a copy, so tiles made by either package's ``mk_test_multifile``
are the same bytes.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from pydem_tpu import fixtures as j_fixtures
from pydem_tpu import manager as j_manager
from pydem_tpu_torch import api, fixtures, manager
from pydem_tpu_torch.api import DEMProcessor
from pydem_tpu_torch.io import read_geotiff
from pydem_tpu_torch.io.store import ArrayStore
from pydem_tpu_torch.manager import ProcessManager

torch.set_num_threads(1)

TEST_NUM = 33
NN = 32
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "deploy",
                          "goldens")
KEYS = ("elev", "aspect", "slope", "uca", "twi")


@pytest.fixture
def debug_pixels():
    """Unit pixel sizes, so tiling is the only variable."""
    manager.DEBUG = True
    yield
    manager.DEBUG = False


@pytest.fixture(scope="module")
def single_uca():
    elev, _a, _u = fixtures.get_test_case(TEST_NUM, NN)
    dp = DEMProcessor(elev=elev, dX=np.ones(NN - 1), dY=np.ones(NN - 1),
                      dX2=np.ones(NN), dY2=np.ones(NN), device="cpu")
    dp.calc_twi()
    return dp


def _pm(in_path, **kw):
    return ProcessManager(in_path=in_path, device="cpu", **kw)


@pytest.mark.parametrize("nx,ny,overlap", [
    (3, 3, 2), (5, 4, 2), (5, 4, 3), (3, 3, 1), (3, 4, 1),
])
def test_multifile_equivalence(tmp_path, single_uca, debug_pixels, nx, ny,
                               overlap):
    chunks = fixtures.mk_test_multifile(
        TEST_NUM, NN, str(tmp_path), nx_grid=nx, ny_grid=ny,
        nx_overlap=overlap, ny_overlap=overlap)
    pm = _pm(chunks, n_workers=1)
    pm.process_twi()
    pm.save_non_overlap_data()
    assert pm.out_file_noverlap["uca"].shape == (NN, NN)
    np.testing.assert_array_almost_equal(
        single_uca.uca[1:-1, 1:-1],
        pm.out_file_noverlap["uca"][1:-1, 1:-1])


def test_geotiff_export_and_overviews(tmp_path, debug_pixels):
    chunks = fixtures.mk_test_multifile(TEST_NUM, NN, str(tmp_path),
                                        nx_grid=2, ny_grid=2,
                                        nx_overlap=2, ny_overlap=2)
    pm = _pm(chunks, n_workers=1)
    pm.process_twi()
    written = pm.save_non_overlap_data_geotiff(str(tmp_path / "out"))
    assert [os.path.basename(f) for f in written] == [k + ".tif"
                                                      for k in KEYS]
    g = read_geotiff(str(tmp_path / "out" / "uca.tif"))
    ref = pm.out_file["uca"].astype("float32")
    nod = np.isnan(ref)  # the streaming writer stores nodata for NaN
    np.testing.assert_array_equal(np.where(nod, 0, g.data),
                                  np.where(nod, 0, ref))
    assert np.all(g.data[nod] == np.float32(-9999.0))
    assert tuple(g.transform) == tuple(pm.transform)
    # the overview pyramid is embedded as subsequent IFDs (factor 3 first)
    for k, fac in enumerate((3, 9, 27), start=1):
        ov = read_geotiff(str(tmp_path / "out" / "uca.tif"), ifd_index=k)
        assert ov.shape[0] == g.shape[0] // fac
    pm.process_overviews(keys=("twi",))
    assert "twi_3" in pm.out_file and "twi_9" in pm.out_file
    pm.save_geotiff("twi", str(tmp_path / "twi_plain.tif"))
    np.testing.assert_array_equal(
        read_geotiff(str(tmp_path / "twi_plain.tif")).data,
        pm.out_file["twi"].astype("float32"))


# -- grid discovery ---------------------------------------------------------

def _write_tile(path, name, block, lat_top, lon_left, pitch):
    from pydem_tpu_torch.geometry import mk_transform
    from pydem_tpu_torch.io.geotiff import write_geotiff

    transform = mk_transform(lat_top, lon_left, -pitch, pitch,
                             lat_lon_centered=False)
    fn = str(path / name)
    write_geotiff(fn, block, transform)
    return fn


def _tile_grid(path, elev, n_tiles=2, pitch=0.01, jitter=0.0, rng=None):
    """Split ``elev`` into an n x n tile grid with optionally float-jittered
    corner coordinates."""
    step = elev.shape[0] // n_tiles
    for ti in range(n_tiles):
        for tj in range(n_tiles):
            block = elev[ti * step:(ti + 1) * step,
                         tj * step:(tj + 1) * step]
            top = 46.0 - ti * step * pitch
            left = -73.0 + tj * step * pitch
            if jitter and rng is not None:
                top += rng.uniform(-jitter, jitter)
                left += rng.uniform(-jitter, jitter)
            _write_tile(path, "t_%d_%d.tif" % (ti, tj), block, top, left,
                        pitch)


def test_grid_jittered_bounds_snap(tmp_path):
    rng = np.random.RandomState(0)
    elev, _a, _u = fixtures.get_test_case(TEST_NUM, NN)
    exact = tmp_path / "exact"
    jit = tmp_path / "jit"
    exact.mkdir(), jit.mkdir()
    _tile_grid(exact, elev)
    _tile_grid(jit, elev, jitter=1e-5, rng=rng)  # ~1e-3 px at pitch 0.01
    pm0, pm1 = _pm(str(exact)), _pm(str(jit))
    assert pm0.compute_grid() == pm1.compute_grid() == (NN, NN)
    assert list(pm0.grid_slice) == list(pm1.grid_slice)
    np.testing.assert_array_equal(pm0._mosaic_elev(), pm1._mosaic_elev())
    # the same discovery as the JAX package's on the same directory
    jm = j_manager.ProcessManager(in_path=str(jit))
    assert jm.compute_grid() == (NN, NN)
    assert list(jm.grid_slice) == list(pm1.grid_slice)
    assert jm.transform == pm1.transform


@pytest.mark.parametrize("fault,match", [
    ("pitch", "pixel pitch"), ("shape", "rows"),
    ("duplicate", "same grid cell"), ("alignment", "aligned"),
])
def test_grid_errors_raise(tmp_path, fault, match):
    """A tile with another pixel pitch, a tile shorter than its grid row, two
    tiles in one grid cell, and a tile off the mosaic's pixel grid are
    refused with an error that says what clashes."""
    elev, _a, _u = fixtures.get_test_case(TEST_NUM, NN)
    _tile_grid(tmp_path, elev)
    kw = {}
    if fault == "pitch":
        _write_tile(tmp_path, "t_bad.tif", elev[:16, :16], 44.0, -73.0, 0.02)
    elif fault == "shape":
        _write_tile(tmp_path, "t_short.tif", elev[:13, :16], 46.0,
                    -73.0 + 2 * 16 * 0.01, 0.01)
    elif fault == "duplicate":
        _write_tile(tmp_path, "t_dup.tif", elev[:16, :16], 46.0, -73.0, 0.01)
    else:
        _write_tile(tmp_path, "t_misaligned.tif", elev[:16, :16],
                    46.0 - 16 * 0.01, -73.0 + (2 * 16 + 0.4) * 0.01, 0.01)
        kw["grid_round_decimals"] = 6
    with pytest.raises(ValueError, match=match):
        _pm(str(tmp_path), **kw).compute_grid()


def test_no_inputs_and_unported_options_raise(tmp_path):
    with pytest.raises(RuntimeError, match="no input rasters"):
        _pm(str(tmp_path)).compute_grid()
    with pytest.raises(RuntimeError, match="no input rasters"):
        _pm(str(tmp_path), out_of_core=True).process_twi()
    from pydem_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        _pm(str(tmp_path), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        _pm(str(tmp_path), mesh=object(), out_of_core=True)
    with pytest.raises(ValueError, match="devices are cuda"):
        _pm(str(tmp_path), mesh=make_mesh(["cuda"] * 2, (1, 2)))


def test_default_device_is_the_card(tmp_path):
    """Without ``device`` the manager runs on the GPU and raises without
    one; it never moves to the CPU by itself."""
    import inspect

    assert (inspect.signature(ProcessManager.__init__).parameters["device"]
            .default == "cuda")
    if torch.cuda.is_available():
        assert ProcessManager(in_path=str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ProcessManager(in_path=str(tmp_path))
    assert _pm(str(tmp_path)).device == torch.device("cpu")


def test_mosaic_overlap_disagreement_warns(tmp_path):
    elev, _a, _u = fixtures.get_test_case(TEST_NUM, NN)
    _tile_grid(tmp_path, elev)
    _write_tile(tmp_path, "t_overlap.tif", elev[:16, :16] + 1.0,
                46.0 - 8 * 0.01, -73.0 + 8 * 0.01, 0.01)
    pm = _pm(str(tmp_path))
    pm.compute_grid()
    with pytest.warns(UserWarning, match="disagree"):
        pm._mosaic_elev()


def test_crash_midstage_resume_bitidentical(tmp_path, debug_pixels):
    """A stage exception lands in errors.json with its traceback, the
    per-stage success columns stay honest, and a ``resume=True`` rerun goes
    on from the stored stages to a bit-identical result."""
    chunks = fixtures.mk_test_multifile(TEST_NUM, NN, str(tmp_path),
                                        nx_grid=2, ny_grid=2,
                                        nx_overlap=2, ny_overlap=2)
    pm0 = _pm(chunks, out_path=str(tmp_path / "clean.zarr"))
    golden = np.array(pm0.process_twi())

    out_dir = str(tmp_path / "crashy.zarr")
    pm1 = _pm(chunks, out_path=out_dir)
    orig = api.DEMProcessor.calc_uca

    def boom(self, *a, **k):
        raise RuntimeError("injected UCA crash")

    api.DEMProcessor.calc_uca = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            pm1.process_twi()
    finally:
        api.DEMProcessor.calc_uca = orig

    s = pm1.out_file["success"]
    assert s.shape[1] == 4
    assert s[:, 0].all() and s[:, 1].all()
    assert not s[:, 2].any() and not s[:, 3].any()
    with open(os.path.join(out_dir, "errors.json")) as f:
        errs = json.load(f)
    assert errs[-1]["stage"] == "uca"
    assert "injected UCA crash" in errs[-1]["traceback"]

    pm2 = _pm(chunks, out_path=out_dir, resume=True)
    twi = np.array(pm2.process_twi())
    np.testing.assert_array_equal(golden, twi)
    assert pm2.out_file["success"].all()

    # a second resume finds every stage done: nothing is timed again
    pm3 = _pm(chunks, out_path=out_dir, resume=True)
    np.testing.assert_array_equal(np.array(pm3.process_twi()), golden)
    assert pm3.timer.report() == {}
    with open(os.path.join(out_dir, "metrics.json")) as f:
        assert json.load(f)["stage_seconds"] == {}


# -- streaming export (tests/test_export_streaming.py on the port) ----------

def _bare_manager(store, tmp_path):
    pm = ProcessManager.__new__(ProcessManager)
    pm.out_file = store
    pm.in_path = str(tmp_path)
    pm.transform = (0.001, 0.0, -105.0, 0.0, -0.001, 41.0)
    pm._projected = False
    return pm


def _no_full_read(self, key):
    raise AssertionError("full-canvas read of %r during export" % key)


def test_export_streams_without_full_reads(tmp_path, monkeypatch):
    """An 8192²-logical store exports through windows only."""
    n = 8192
    store = ArrayStore(str(tmp_path / "results.zarr"))
    store.create("twi", (n, n), "float64", chunks=(256, 256), fill=1.25)
    store.write_window("twi", np.full((256, 256), 7.5), (256, 512))
    pm = _bare_manager(store, tmp_path)
    monkeypatch.setattr(ArrayStore, "__getitem__", _no_full_read)
    out = str(tmp_path / "twi.tif")
    pm.save_geotiff_tiled("twi", out, overview_factors=(32,))
    g = read_geotiff(out)
    assert g.shape == (n, n)
    assert g.data[300, 600] == np.float32(7.5)
    assert g.data[0, 0] == np.float32(1.25)
    assert read_geotiff(out, ifd_index=1).shape == (n // 32, n // 32)


def test_default_export_is_streaming(tmp_path, monkeypatch):
    store = ArrayStore(str(tmp_path / "results.zarr"))
    store.create("uca", (64, 64), "float64", chunks=(32, 32), fill=2.0)
    pm = _bare_manager(store, tmp_path)
    monkeypatch.setattr(ArrayStore, "__getitem__", _no_full_read)
    written = pm.save_non_overlap_data_geotiff(
        out_path=str(tmp_path / "out"), overview_factors=())
    assert written and written[0].endswith("uca.tif")
    g = read_geotiff(written[0])
    assert g.shape == (64, 64) and g.data[5, 5] == np.float32(2.0)


def test_non_overlap_store_streams(tmp_path, monkeypatch):
    n = 8192
    store = ArrayStore(str(tmp_path / "results.zarr"))
    store.create("uca", (n, n), "float64", chunks=(256, 256), fill=np.nan)
    store.write_window("uca", np.full((256, 256), 3.5), (512, 256))
    store.create("twi", (n, n), "float32", chunks=(256, 256), fill=np.nan)
    pm = _bare_manager(store, tmp_path)
    monkeypatch.setattr(ArrayStore, "__getitem__", _no_full_read)
    dst = pm.save_non_overlap_data(keys=["uca", "twi"], chunk=2048)
    monkeypatch.undo()
    assert dst is pm.out_file_noverlap
    assert dst._meta("uca")["shape"] == [n, n]
    assert dst._meta("twi")["dtype"] == "<f4"
    assert (dst.read_window("uca", (512, 768), (256, 512)) == 3.5).all()
    assert np.isnan(dst.read_window("uca", (0, 16), (0, 16))).all()


# -- against the JAX manager and the goldens --------------------------------

@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """The configuration of ``deploy/golden_check.py`` through both
    managers, on tiles written by each package's own fixtures module."""
    work = tmp_path_factory.mktemp("golden")
    t_tiles = fixtures.mk_test_multifile(33, 64, str(work / "t"), nx_grid=2,
                                         ny_grid=2, nx_overlap=2,
                                         ny_overlap=2)
    j_tiles = j_fixtures.mk_test_multifile(33, 64, str(work / "j"), nx_grid=2,
                                           ny_grid=2, nx_overlap=2,
                                           ny_overlap=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = _pm(t_tiles, out_path=str(work / "t.zarr"))
        pm.process_twi()
        written = pm.save_non_overlap_data_geotiff(str(work / "t_out"))
        jm = j_manager.ProcessManager(in_path=j_tiles,
                                      out_path=str(work / "j.zarr"))
        jm.process_twi()
    return pm, jm, written, t_tiles, j_tiles


def test_tiles_are_the_same_bytes(golden_run):
    _pm_, _jm, _w, t_tiles, j_tiles = golden_run
    names = sorted(os.listdir(j_tiles))
    assert names == sorted(os.listdir(t_tiles)) and len(names) == 4
    for fn in names:
        with open(os.path.join(t_tiles, fn), "rb") as a, \
                open(os.path.join(j_tiles, fn), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("key", ["elev", "aspect", "slope", "uca", "twi",
                                 "edge_todo", "edge_done", "uca_edges",
                                 "uca_edge_metrics", "success"])
def test_store_matches_jax_manager(golden_run, key):
    pm, jm, *_ = golden_run
    got, want = pm.out_file[key], jm.out_file[key]
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind in "biu" or key == "elev":
        np.testing.assert_array_equal(got, want)
    else:
        if key.startswith("uca"):  # in pixels
            px = np.nanmin(want)
            got, want = got / px, want / px
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_almost_equal(np.nan_to_num(got),
                                             np.nan_to_num(want), decimal=10)
    if key == "success":
        assert got.all() and got.shape == (4, 4)


def test_metrics_match_jax_manager(golden_run):
    pm, jm, *_ = golden_run
    with open(os.path.join(pm.out_path, "metrics.json")) as f:
        got = json.load(f)
    with open(os.path.join(jm.out_path, "metrics.json")) as f:
        want = json.load(f)
    assert sorted(got["stage_seconds"]) == sorted(want["stage_seconds"]) == \
        ["aspect_slope", "elevation", "twi", "uca"]
    for k in ("uca_iters_to_converge", "canvas_shape", "n_tiles"):
        assert got[k] == want[k]
    assert pm.compute_grid() == (64, 64)


@pytest.mark.parametrize("key", KEYS)
def test_export_equals_goldens(golden_run, key):
    """Each exported GeoTIFF equals ``deploy/goldens/<key>.tif`` byte for
    byte: values, nodata, overview IFDs and container alike."""
    _pm_, _jm, written, *_ = golden_run
    fn = [f for f in written if os.path.basename(f) == key + ".tif"][0]
    exp_fn = os.path.join(GOLDEN_DIR, key + ".tif")
    got, exp = read_geotiff(fn), read_geotiff(exp_fn)
    np.testing.assert_array_equal(got.data, exp.data)
    assert tuple(got.transform) == tuple(exp.transform)
    with open(fn, "rb") as a, open(exp_fn, "rb") as b:
        assert a.read() == b.read()


def test_device_backends_through_the_manager(tmp_path, single_uca,
                                             debug_pixels):
    """``dem_proc_kwargs`` reach the processor: with both backends on the
    device the manager's stages run the device chain (fill, carve,
    slope/section, pit links, solve) and give the host route's mosaic."""
    chunks = fixtures.mk_test_multifile(TEST_NUM, NN, str(tmp_path),
                                        nx_grid=2, ny_grid=2, nx_overlap=2,
                                        ny_overlap=2)
    pm = _pm(chunks, dem_proc_kwargs=dict(conditioning_backend="device",
                                          pit_backend="device"))
    pm.process_twi()
    assert pm._dp._dev("section") is not None  # the device chain ran
    np.testing.assert_array_almost_equal(single_uca.uca[1:-1, 1:-1],
                                         pm.out_file["uca"][1:-1, 1:-1])
    assert pm.out_file["edge_done"].dtype == bool


# -- out of core --------------------------------------------------------------

@pytest.fixture(scope="module")
def ooc_runs(tmp_path_factory):
    """The same 2×2 tiles (fixture 33, 32², overlap 2, unit pixels) through
    the port's in-memory manager, the port's out-of-core manager and the JAX
    package's out-of-core manager (the case of
    ``tests/test_outofcore.py::test_manager_out_of_core_end_to_end``).

    The JAX engine's slope stage runs op by op (``jax.disable_jit()`` around
    its ``_slope_program``): jitted on the CPU, XLA contracts an FMA in the
    facet sweep and flips a near-tie facet of this fixture at 32², as it does
    for the in-core chain (``tests/test_torch_api_host.py``)."""
    import jax

    from pydem_tpu import outofcore as j_outofcore

    tmp = tmp_path_factory.mktemp("ooc")
    manager.DEBUG = j_manager.DEBUG = True
    jitted = j_outofcore._slope_program

    def op_by_op(*args):
        with jax.disable_jit():
            return jitted(*args)

    j_outofcore._slope_program = op_by_op
    try:
        chunks = fixtures.mk_test_multifile(TEST_NUM, NN, str(tmp),
                                            nx_grid=2, ny_grid=2,
                                            nx_overlap=2, ny_overlap=2)
        mem = _pm(chunks, out_path=str(tmp / "mem.zarr"))
        mem.process_twi()
        ooc = _pm(chunks, out_of_core=True, superblock=16,
                  out_path=str(tmp / "ooc.zarr"))
        ret = ooc.process_twi()
        jm = j_manager.ProcessManager(in_path=chunks, out_of_core=True,
                                      superblock=16,
                                      out_path=str(tmp / "jax.zarr"))
        jm.process_twi()
        yield mem, ooc, jm, ret, chunks
    finally:
        manager.DEBUG = j_manager.DEBUG = False
        j_outofcore._slope_program = jitted


@pytest.mark.parametrize("key", KEYS)
def test_out_of_core_matches_in_memory_and_jax(ooc_runs, key):
    mem, ooc, jm, _ret, _chunks = ooc_runs
    got = ooc.out_file[key]
    assert got.shape == (NN, NN) and got.dtype == np.float64
    a = mem.out_file[key]
    assert (np.isnan(a) == np.isnan(got)).all()
    np.testing.assert_array_almost_equal(np.nan_to_num(a),
                                         np.nan_to_num(got))
    want = jm.out_file[key]
    assert (np.isnan(want) == np.isnan(got)).all()
    if key == "elev":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_almost_equal(
            np.nan_to_num(got), np.nan_to_num(want), decimal=10)


def test_out_of_core_store_surface(ooc_runs):
    """The out-of-core run returns the store, never the canvas, and leaves
    the arrays and metrics of the in-core stages."""
    _mem, ooc, jm, ret, _chunks = ooc_runs
    assert ret is ooc.out_file and ooc._dp is None
    assert ooc._ooc.device == torch.device("cpu") and ooc._ooc.S == 16
    for key in ("elev_src", "flats", "uca_state", "edge_todo", "edge_done",
                "uca_edges", "uca_edge_metrics", "success"):
        assert key in ooc.out_file, key
        got, want = ooc.out_file[key], jm.out_file[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
    assert ooc.out_file["success"].all()
    assert ooc.out_file["edge_done"].all()
    assert not ooc.out_file["edge_todo"].any()
    np.testing.assert_array_equal(ooc.out_file["uca_edges"],
                                  ooc.out_file["uca"])
    with open(os.path.join(ooc.out_path, "metrics.json")) as f:
        got = json.load(f)
    with open(os.path.join(jm.out_path, "metrics.json")) as f:
        want = json.load(f)
    assert sorted(got["stage_seconds"]) == sorted(want["stage_seconds"])
    assert got["uca_iters_to_converge"] == ooc._ooc.uca_rounds >= 1
    assert got["halo_fraction"] == want["halo_fraction"]
    assert got["canvas_shape"] == want["canvas_shape"] == [NN, NN]


def test_out_of_core_resume_and_export(ooc_runs, tmp_path):
    """A ``resume=True`` rerun on the finished store runs no stage and keeps
    the arrays; the streaming GeoTIFF export reads the out-of-core store."""
    _mem, ooc, _jm, _ret, chunks = ooc_runs
    manager.DEBUG = True
    try:
        uca0 = ooc.out_file["uca"]
        pm = _pm(chunks, out_of_core=True, superblock=16, resume=True,
                 out_path=ooc.out_path)
        pm.process_twi()
        assert sorted(pm.timer.report()) == ["ingest"]
        assert pm._ooc.uca_rounds == ooc._ooc.uca_rounds
        np.testing.assert_array_equal(pm.out_file["uca"], uca0)
        written = pm.save_non_overlap_data_geotiff(str(tmp_path / "out"))
    finally:
        manager.DEBUG = False
    assert [os.path.basename(f) for f in written] == [k + ".tif"
                                                      for k in KEYS]
    g = read_geotiff(str(tmp_path / "out" / "uca.tif"))
    ref = uca0.astype("float32")
    np.testing.assert_array_equal(
        g.data, np.where(np.isnan(ref), np.float32(-9999), ref))


# -- over a mesh --------------------------------------------------------------

def _cpu_mesh(shape=(2, 4)):
    from pydem_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


@pytest.fixture(scope="module")
def mesh_runs(ooc_runs, tmp_path_factory):
    """The tiles of ``ooc_runs`` through ``ProcessManager(mesh=2×4 CPU
    devices)`` with each UCA solver: the streaming route with the engine's
    UCA sharded (the JAX manager's mesh route)."""
    mem, _ooc, _jm, _ret, chunks = ooc_runs
    tmp = tmp_path_factory.mktemp("mesh")
    manager.DEBUG = True
    try:
        runs = {}
        for solver in ("jacobi", "blocked"):
            pm = _pm(chunks, mesh=_cpu_mesh(), out_path=str(tmp / solver),
                     superblock=32,
                     dem_proc_kwargs=dict(uca_solver=solver))
            runs[solver] = (pm, pm.process_twi())
        yield mem, runs
    finally:
        manager.DEBUG = False


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
def test_mesh_manager_matches_in_memory(mesh_runs, solver, key):
    """ProcessManager(mesh=...) == the in-memory manager on the same tiles,
    atol 1e-10 (``tests/test_manager_mesh.py`` of the JAX package)."""
    mem, runs = mesh_runs
    pm, twi = runs[solver]
    a, b = mem.out_file[key], pm.out_file[key]
    assert (np.isnan(a) == np.isnan(b)).all()
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               atol=1e-10, err_msg=key)
    np.testing.assert_array_equal(twi, pm.out_file["twi"])
    assert pm._ooc.mesh is pm.mesh and pm.out_file["success"].all()


def test_mesh_stages_run_the_sharded_pipeline(tmp_path, debug_pixels):
    """Stage by stage, a mesh manager runs ShardedPipeline on the mosaic:
    on a pit-rich fixture with conditioning off (its pit links cross the
    shards) aspect, slope and uca equal the in-memory manager's, atol
    1e-10; metrics.json carries the halo geometry and, asked for, the timed
    overlap."""
    opts = dict(fill_flats=False, drain_pits_path=False)
    chunks = fixtures.mk_test_multifile(13, NN, str(tmp_path), nx_grid=2,
                                        ny_grid=2, nx_overlap=2, ny_overlap=2)
    pms = [_pm(chunks, out_path=str(tmp_path / "mem.zarr"),
               dem_proc_kwargs=opts),
           _pm(chunks, out_path=str(tmp_path / "mesh.zarr"), mesh=_cpu_mesh(),
               dem_proc_kwargs=dict(opts, uca_solver="blocked"),
               measure_halo_overlap=True)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for pm in pms:
            pm.compute_grid()
            pm.process_elevation()
            pm.process_aspect_slope()
            pm.process_uca()
            pm._dump_metrics()
    mem, mesh = pms
    assert mesh._sp is not None and mesh._sp.uca_solver == "blocked"
    for key in ("aspect", "slope", "uca"):
        a, b = mem.out_file[key], mesh.out_file[key]
        assert (np.isnan(a) == np.isnan(b)).all(), key
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-10, err_msg=key)
    with open(os.path.join(mesh.out_path, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["mesh_shape"] == [2, 4]
    assert metrics["uca_iters_to_converge"] == mesh._sp.uca_rounds >= 1
    assert metrics["timer"] == "host clock" and "overlap_fraction" in metrics


def test_mesh_route_never_materializes_the_host_mosaic(tmp_path,
                                                       monkeypatch,
                                                       debug_pixels):
    def boom(self):
        raise AssertionError("the mesh route mosaicked the tiles on the host")

    monkeypatch.setattr(ProcessManager, "_mosaic_elev", boom)
    chunks = fixtures.mk_test_multifile(TEST_NUM, NN, str(tmp_path),
                                        nx_grid=2, ny_grid=2, nx_overlap=2,
                                        ny_overlap=2)
    pm = _pm(chunks, mesh=_cpu_mesh((2, 2)), superblock=32)
    twi = pm.process_twi()
    assert np.isfinite(twi).any() and pm.out_file["success"].all()
