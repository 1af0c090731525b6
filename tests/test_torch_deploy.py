"""The port's deployment periphery on the CPU (float64): the cloud-burst
queue, submit and worker (``pydem_tpu_torch/deploy``), the golden check,
the examples, the two measuring tools and the package-root surface,
against the JAX package's counterparts where they exist.

The job queue's files are the JAX queue's, so either side's workers drain
the other's jobs; the workers here run as the JAX ones do in
``tests/test_cloud_burst.py``, and their stores are held to the same JAX
``DEMProcessor`` golden and, exactly, to the port's in-process run."""
import ast
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from deploy.cloud import jobqueue as j_q
from deploy.cloud import submit as j_submit
from pydem_tpu_torch import fixtures
from pydem_tpu_torch.deploy import golden_check, jobqueue as q, submit, worker
from pydem_tpu_torch.io.store import ArrayStore
from pydem_tpu_torch.manager import ProcessManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
GOLDEN_DIR = os.path.join(REPO, "deploy", "goldens")
KEYS = ("elev", "aspect", "slope", "uca", "twi")

torch.set_num_threads(1)


def _mk_region(tmp_path, name, NN=32):
    return fixtures.mk_test_multifile(33, NN, str(tmp_path / name),
                                      nx_grid=2, ny_grid=2,
                                      nx_overlap=2, ny_overlap=2)


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX ``DEMProcessor`` on fixture 33 at 32², unit pixels (the
    golden of ``tests/test_cloud_burst.py``), op by op: jitted on the CPU,
    XLA contracts an FMA in the facet sweep and flips a near-tie facet of
    this fixture at 32² (ROADMAP queue 3)."""
    import jax

    from pydem_tpu import DEMProcessor as JDEMProcessor
    from pydem_tpu import fixtures as j_fixtures

    NN = 32
    elev, _a, _u = j_fixtures.get_test_case(33, NN)
    with jax.disable_jit():
        dp = JDEMProcessor(elev=elev, dX=np.ones(NN - 1), dY=np.ones(NN - 1),
                           dX2=np.ones(NN), dY2=np.ones(NN))
        dp.calc_twi()
    return np.asarray(dp.uca)


def _in_process(region, out_path, export=None):
    """The port's ProcessManager on one region, as a job runs it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = ProcessManager(in_path=region, out_path=out_path, resume=True,
                            _debug=True, device="cpu")
        pm.process_twi()
        if export:
            pm.save_non_overlap_data_geotiff(export)
    return ArrayStore(out_path)


def _assert_golden(uca, golden):
    np.testing.assert_array_almost_equal(np.nan_to_num(golden)[1:-1, 1:-1],
                                         np.nan_to_num(uca)[1:-1, 1:-1])


def _worker(queue, *extra):
    return subprocess.run(
        [sys.executable, "-m", "pydem_tpu_torch.deploy.worker", "--queue",
         queue, "--drain", "--lease", "600", "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=300, env=ENV)


# -- the queue -----------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(j_q, q), (q, j_q)],
                         ids=["jax_to_port", "port_to_jax"])
def test_queue_interoperates(tmp_path, writer, reader):
    """A job one side enqueued is claimed, stolen after its lease and
    finished by the other, and each step leaves the files the other side
    leaves."""
    spec = {"in_path": "/data/r1", "out_of_core": False, "superblock": 512}
    for side, queue in ((writer, "qa"), (reader, "qb")):
        assert side.submit(str(tmp_path / queue), "r1", spec)
        assert not side.submit(str(tmp_path / queue), "r1", {"x": 2})
    with open(tmp_path / "qa" / "jobs" / "r1.json", "rb") as a, \
            open(tmp_path / "qb" / "jobs" / "r1.json", "rb") as b:
        assert a.read() == b.read()

    queue = str(tmp_path / "qa")
    name, got, claim = reader.claim_next(queue)
    assert (name, got) == ("r1", spec)
    assert claim == os.path.join(queue, "jobs",
                                 "r1.json.claimed-" + j_q.worker_id())
    assert writer.claim_next(queue, lease_s=600) is None
    assert writer.status(queue) == reader.status(queue)
    os.utime(claim, (time.time() - 1e4, time.time() - 1e4))  # preempted
    stolen = writer.claim_next(queue, lease_s=600)
    assert stolen is not None and stolen[0] == "r1"
    reader.finish(stolen[2], result={"canvas_shape": [32, 32]})
    with open(os.path.join(queue, "jobs", "r1.json.done")) as f:
        done = json.load(f)
    assert sorted(done) == ["error", "finished", "result", "worker"]
    assert done["result"] == {"canvas_shape": [32, 32]}
    assert done["worker"] == j_q.worker_id() and done["error"] is None
    assert writer.status(queue) == reader.status(queue) == {
        "pending": [], "claimed": [], "done": ["r1"], "failed": []}


def test_submit_names_and_specs_equal_jax_submit(tmp_path):
    """Enqueue-only submits of both packages write the same job files."""
    regions = [_mk_region(tmp_path, "r1"), _mk_region(tmp_path, "r2")]
    common = [*regions, "--export-root", str(tmp_path / "out"),
              "--superblock", "64", "--dem-proc-kwargs",
              '{"uca_solver": "blocked"}', "--debug-unit-pixels"]
    assert j_submit.main(["--queue", str(tmp_path / "qj"), *common]) == 0
    assert submit.main(["--queue", str(tmp_path / "qt"), *common]) == 0
    jobs_j = sorted(os.listdir(tmp_path / "qj" / "jobs"))
    assert jobs_j == sorted(os.listdir(tmp_path / "qt" / "jobs"))
    assert jobs_j == sorted(submit.job_name(r) + ".json" for r in regions)
    for fn in jobs_j:
        with open(tmp_path / "qj" / "jobs" / fn, "rb") as a, \
                open(tmp_path / "qt" / "jobs" / fn, "rb") as b:
            assert a.read() == b.read()


# -- submit and workers ------------------------------------------------------

def test_submit_and_local_workers_end_to_end(tmp_path, jax_golden):
    regions = [_mk_region(tmp_path, "r1"), _mk_region(tmp_path, "r2")]
    queue = str(tmp_path / "q")
    out = str(tmp_path / "out")
    p = subprocess.run(
        [sys.executable, "-m", "pydem_tpu_torch.deploy.submit", "--queue",
         queue, *regions, "--local-workers", "2", "--device", "cpu",
         "--export-root", out, "--debug-unit-pixels"],
        capture_output=True, text=True, timeout=300, env=ENV)
    assert p.returncode == 0, p.stdout + p.stderr
    st = q.status(queue)
    assert len(st["done"]) == 2 and not st["failed"], st
    startups = [json.loads(line.split(": ", 1)[1])
                for line in p.stdout.splitlines() if " start-up on cpu: "
                in line]
    assert len(startups) == 2
    for s in startups:
        assert set(s) == {"torch_import_s", "package_import_s", "total_s"}

    for r in regions:
        name = submit.job_name(r)
        with open(os.path.join(queue, "jobs", name + ".json.done")) as f:
            assert json.load(f)["result"] == {
                "canvas_shape": [32, 32], "n_tiles": 4, "uca_rounds": 20}
        got = ArrayStore(os.path.join(r, "results.zarr"))
        _assert_golden(got["uca"], jax_golden)
        want = _in_process(r, str(tmp_path / (name + ".zarr")),
                           export=str(tmp_path / (name + "_tif")))
        for key in ("uca", "twi"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in KEYS:
            with open(os.path.join(out, name, key + ".tif"), "rb") as a, \
                    open(tmp_path / (name + "_tif") / (key + ".tif"),
                         "rb") as b:
                assert a.read() == b.read()


def test_worker_resumes_preempted_job(tmp_path, jax_golden):
    """A job claimed by a dead worker after its elevation stage is stolen
    after the lease and finished to the uninterrupted result."""
    region = _mk_region(tmp_path, "r1")
    queue = str(tmp_path / "q")
    assert q.submit(queue, "r1", {"in_path": region, "_debug": True})

    _name, _spec, claim = q.claim_next(queue)
    pm = ProcessManager(in_path=region, resume=True, _debug=True,
                        device="cpu")
    pm.compute_grid()
    pm._success_init()
    pm._stage_guarded("elevation", pm.process_elevation)
    store = ArrayStore(os.path.join(region, "results.zarr"))
    assert "elev" in store and "uca" not in store
    os.utime(claim, (time.time() - 1e4, time.time() - 1e4))  # lease expires

    p = _worker(queue)
    assert p.returncode == 0, p.stdout + p.stderr
    assert q.status(queue)["done"] == ["r1"]
    got = ArrayStore(os.path.join(region, "results.zarr"))
    _assert_golden(got["uca"], jax_golden)
    want = _in_process(_mk_region(tmp_path, "fresh"),
                       str(tmp_path / "fresh.zarr"))
    for key in ("uca", "twi"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("writer", ["jax", "float32"])
def test_worker_refuses_a_store_another_writer_started(tmp_path, writer):
    """A job preempted after its elevation stage on another kind of worker
    (the JAX one, or a port worker on the card, float32) is not resumed from
    the store it left: the job fails and the worker drains on."""
    region = _mk_region(tmp_path, "r1")
    store = os.path.join(region, "results.zarr")
    queue = str(tmp_path / "q")
    assert q.submit(queue, "r1", {"in_path": region, "_debug": True})
    _name, _spec, claim = q.claim_next(queue)
    if writer == "jax":
        from pydem_tpu.manager import ProcessManager as JProcessManager

        pm = JProcessManager(in_path=region, resume=True, _debug=True)
    else:
        pm = ProcessManager(in_path=region, resume=True, _debug=True,
                            device="cpu")
    pm.compute_grid()
    pm._success_init()
    pm._stage_guarded("elevation", pm.process_elevation)
    if writer == "float32":  # what a worker on the card leaves
        with open(os.path.join(store, ProcessManager.PRODUCER), "w") as f:
            json.dump({"package": "pydem_tpu_torch", "dtype": "float32"}, f)
    elev = ArrayStore(store)["elev"]
    os.utime(claim, (time.time() - 1e4, time.time() - 1e4))  # lease expires

    assert worker.main(["--queue", queue, "--drain", "--device", "cpu"]) == 0
    assert q.status(queue)["failed"] == ["r1"]
    with open(os.path.join(queue, "jobs", "r1.json.failed")) as f:
        assert "resuming would mix their stages" in json.load(f)["error"]
    got = ArrayStore(store)
    assert "uca" not in got and got["elev"].tobytes() == elev.tobytes()


def test_missing_input_fails_and_worker_drains_on(tmp_path):
    region = _mk_region(tmp_path, "r1")
    queue = str(tmp_path / "q")
    assert q.submit(queue, "a-missing", {"in_path": str(tmp_path / "none")})
    assert q.submit(queue, "b-good", {"in_path": region, "_debug": True})
    assert worker.main(["--queue", queue, "--drain", "--device", "cpu"]) == 0
    st = q.status(queue)
    assert st["failed"] == ["a-missing"] and st["done"] == ["b-good"]
    with open(os.path.join(queue, "jobs", "a-missing.json.failed")) as f:
        assert "FileNotFoundError" in json.load(f)["error"]


@pytest.mark.parametrize("exc,fault", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.AcceleratorError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("uca_gs_round_dataflow_f32 launch failed: cudaError 700"),
     True),
    (torch.OutOfMemoryError("CUDA out of memory."), False),
    (ValueError("bad spec"), False),
], ids=["runtime", "accelerator", "kernel_launch", "oom", "other"])
def test_cuda_fault_marks_failed_and_exits(tmp_path, monkeypatch, exc,
                                           fault):
    """A CUDA fault fails its job and ends the worker before the next job
    (never a retry on the CPU); any other error fails the job and the
    worker drains on."""
    queue = str(tmp_path / "q")
    assert q.submit(queue, "a", {"in_path": "x"})
    assert q.submit(queue, "b", {"in_path": "y"})
    seen = []

    def run_job(name, spec, device):
        seen.append((name, device))
        raise exc

    monkeypatch.setattr(worker, "run_job", run_job)
    rc = worker.main(["--queue", queue, "--drain", "--device", "cpu"])
    st = q.status(queue)
    if fault:
        assert rc == worker.EXIT_CUDA_FAULT
        assert st == {"pending": ["b"], "claimed": [], "done": [],
                      "failed": ["a"]}
    else:
        assert rc == 0 and st["failed"] == ["a", "b"]
    assert all(d == torch.device("cpu") for _n, d in seen)
    assert worker.is_cuda_fault(exc) is fault
    wrapped = RuntimeError("stage uca")
    wrapped.__cause__ = exc
    assert worker.is_cuda_fault(wrapped) is fault


def test_worker_default_device_raises_before_claiming(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    queue = str(tmp_path / "q")
    assert q.submit(queue, "a", {"in_path": "x"})
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        worker.main(["--queue", queue, "--drain"])
    assert q.status(queue)["pending"] == ["a"]


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 2, ["cuda:0", "cuda:1", "cuda:0"]),
    ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda:1", 2, ["cuda:1"] * 3),
    ("cpu", 0, ["cpu"] * 3),
])
def test_submit_spreads_workers_over_cards(monkeypatch, device, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cmds = submit.worker_commands("/q", 3, device, 600)
    assert [c[c.index("--device") + 1] for c in cmds] == want
    for c in cmds:
        assert c[:3] == [sys.executable, "-m",
                         "pydem_tpu_torch.deploy.worker"]
        assert c[c.index("--queue") + 1] == "/q" and "--drain" in c


def test_submit_cuda_workers_raise_without_cards(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        submit.main(["--queue", str(tmp_path / "q"), "--local-workers", "1"])


# -- the golden check ----------------------------------------------------------

def test_golden_check_cpu_is_byte_for_byte(capsys):
    assert golden_check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("bitwise") == len(KEYS) and "byte for byte" in out


def test_golden_check_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        golden_check.main([])


def test_golden_envelope_figures():
    exp = np.array([[1.0, 2.0, -9999.0], [4.0, 0.5, 1.0]], "float32")
    got = exp.copy()
    got[0, 0] = 1.0 + 1e-3
    fig = golden_check.envelope(got, exp)
    assert fig["nan_match"] and fig["max"] == pytest.approx(1e-3, rel=1e-3)
    got[1, 1] = -9999.0
    assert not golden_check.envelope(got, exp)["nan_match"]


# -- the examples and the tools -----------------------------------------------

def test_example_process_array(tmp_path, monkeypatch):
    from pydem_tpu_torch.api import DEMProcessor
    from pydem_tpu_torch.examples import process_array

    monkeypatch.chdir(tmp_path)
    got = process_array.main(["--device", "cpu"])
    assert not os.listdir(tmp_path)
    x, y = np.mgrid[-1:1:256j, -1:1:256j]
    elev = np.round((1 - np.sqrt(x**2 + y**2)) * 50) / 50 + 0.05
    dp = DEMProcessor(elev=elev, dX=30.0, dY=30.0, device="cpu")
    np.testing.assert_array_equal(got["twi"], dp.calc_twi())
    np.testing.assert_array_equal(got["uca"], dp.uca)
    assert np.isfinite(got["uca"]).any()


def test_example_process_manager_directory_equals_goldens(tmp_path):
    """The example's demo tiles are the golden check's configuration."""
    from pydem_tpu_torch.examples import process_manager_directory as ex

    tiles = fixtures.mk_test_multifile(33, 64, str(tmp_path), nx_grid=2,
                                       ny_grid=2, nx_overlap=2, ny_overlap=2)
    _pm, written = ex.main([tiles, "--device", "cpu"])
    assert sorted(os.path.basename(f) for f in written) == \
        sorted(k + ".tif" for k in KEYS)
    for fn in written:
        with open(fn, "rb") as a, open(os.path.join(
                GOLDEN_DIR, os.path.basename(fn)), "rb") as b:
            assert a.read() == b.read()


def test_hard_breakdown_on_the_cpu():
    from pydem_tpu_torch.api import DEMProcessor
    from pydem_tpu_torch.tools import hard_breakdown as hb

    out = hb.main(["--device", "cpu", "--n", "64"])
    assert {s["clock"] for s in out["stages"].values()} == {"host"}
    labels = list(out["stages"])
    assert labels[0] == "elev upload" and labels[-1] == "twi download"
    for part in ("stages", "sum", "chain", "ratio"):
        reps = [out[part]["reps"]] if part != "stages" else \
            [s["reps"] for s in out["stages"].values()]
        assert all(len(r) == 3 and min(r) >= 0 for r in reps)
    sums = [sum(s["reps"][i] for s in out["stages"].values())
            for i in range(3)]
    assert out["sum"]["median"] == pytest.approx(np.median(sums))
    assert out["ratio"]["reps"] == pytest.approx(
        [a / b for a, b in zip(sums, out["chain"]["reps"])])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = DEMProcessor(elev=hb.make_hard_terrain(64), device="cpu",
                          **hb.CHAIN)
        dp.calc_twi()
    assert out["uca_rounds"] == dp.uca_sweeps
    with pytest.raises(ValueError):
        hb.breakdown(64, reps=2, device="cpu")


def test_make_hard_terrain_moved_bitwise():
    import bench
    from pydem_tpu_torch.tools.hard_breakdown import make_hard_terrain

    for n, dtype in ((64, "float64"), (257, "float32")):
        a, b = make_hard_terrain(n, dtype), bench.make_hard_terrain(n, dtype)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_mesh_scaling_rounds_equal_across_shapes():
    from pydem_tpu_torch.parallel.sharded import terrain_step
    from pydem_tpu_torch.tools import mesh_scaling

    n = 256
    out = mesh_scaling.main(["--device", "cpu", "--n", str(n)])
    assert [r["shape"] for r in out["rows"]] == [[1, 1], [1, 2], [2, 2]]
    elev = torch.as_tensor(mesh_scaling.cone(n), dtype=torch.float32)
    ones = lambda k: torch.ones(k, dtype=torch.float32)  # noqa: E731
    one = terrain_step(elev, ones(n - 1), ones(n - 1), ones(n), ones(n),
                       uca_solver="blocked")["uca_sweeps"]
    assert [r["rounds"] for r in out["rows"]] == [int(one)] * 3
    for r in out["rows"]:
        gy, gx = r["shape"]
        assert r["ring_bytes_per_round"] == \
            (2 * (n // gy + 2) + 2 * (n // gx)) * 4 * gy * gx
        assert r["t_full_per_round"] > 0 and r["timer"] == "host clock"
    assert [f["impl"] for f in out["flood"]] == ["global", "sharded",
                                                 "sharded"]


@pytest.mark.parametrize("tool", ["hard_breakdown", "mesh_scaling",
                                  "process_array"])
def test_tools_and_examples_default_to_the_card(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    pkg = "examples" if tool.startswith("process") else "tools"
    mod = importlib.import_module("pydem_tpu_torch.%s.%s" % (pkg, tool))
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        mod.main([] if pkg == "examples" else ["--n", "64"])


# -- the package root and its imports ----------------------------------------

def test_root_surface():
    import pydem_tpu
    import pydem_tpu_torch
    from pydem_tpu_torch import api, geometry, manager, utils

    assert pydem_tpu_torch.DEMProcessor is api.DEMProcessor
    assert pydem_tpu_torch.utils_test_pydem is pydem_tpu_torch.fixtures \
        is fixtures
    assert pydem_tpu_torch.process_manager is manager
    assert pydem_tpu_torch.geometry is geometry
    assert pydem_tpu_torch.utils is utils
    for name in ("DEMProcessor", "fixtures", "geometry", "utils",
                 "process_manager", "utils_test_pydem"):
        assert hasattr(pydem_tpu, name) and name in dir(pydem_tpu_torch)
    with pytest.raises(AttributeError):
        pydem_tpu_torch.no_such_name  # noqa: B018


def test_bare_import_loads_no_submodule():
    code = ("import sys, pydem_tpu_torch\n"
            "assert pydem_tpu_torch.default_dtype('cpu') is not None\n"
            "mods = [m for m in sys.modules if m.startswith('pydem_tpu')]\n"
            "assert mods == ['pydem_tpu_torch'], mods\n"
            "assert 'pydem_tpu_torch.ops.uca_block' not in sys.modules\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=ENV, cwd=REPO)
    assert p.returncode == 0, p.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_side():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "pydem_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    banned = ("jax", "jaxlib", "pydem_tpu", "deploy", "tools", "bench")
    for path in paths:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)
