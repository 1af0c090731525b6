"""A run rehearsed on the CPU at a tiny size (the port's CPU path): the
window's arithmetic, the result line, and what a run may load."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time
from argparse import Namespace

import pytest

from hydrobench import harness, manifest
from hydrobench import run as runner

ROOT = manifest.ROOT
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_window_counts_the_straddling_tile():
    t0 = time.perf_counter()
    run, kept, _pool, _order = harness.run(BENCH, CELLS[0], 17, 0.4, False,
                                           "cpu", t0, shape=(64, 64))
    lat = [t.latency_s for t in run.tiles]
    assert len(lat) >= 2 and kept
    # the last tile started before the deadline and ended after it
    assert run.window_s >= 0.4 > run.window_s - lat[-1] - 1e-3
    # the window is the tiles back to back, nothing else
    assert sum(lat) <= run.window_s < sum(lat) + 0.05 * run.window_s + 0.01
    m = harness.metrics(BENCH, run, False)
    assert m["tile_mpx_s"]["value"] == pytest.approx(
        64 * 64 * len(lat) / run.window_s / 1e6)
    assert 0 < run.setup_s < run.window_s + 600


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    args = Namespace(workload=cell, seed=2 ** 33 + 7, seconds=0.2,
                     trace=trace)
    out = runner.result(BENCH, args, "cpu", time.perf_counter(),
                        shape=(64, 64))
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in manifest.metrics_of(BENCH, cell, trace)}
    assert set(line["metrics"]) <= want
    for name, v in line["metrics"].items():
        assert isinstance(v["value"], float) or isinstance(v["value"], int)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # device metrics have nothing to read on the CPU, and say nothing
        assert "k1_roofline_pct" not in line["metrics"]
        assert "device_idle_pct" not in line["metrics"]
        assert {"stencil_ms", "uca_solve_ms", "uca_rounds"} <= set(
            line["metrics"])
    else:
        assert {"tile_mpx_s", "setup_s"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "hydrobench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from argparse import Namespace\n"
        "from hydrobench import manifest, run\n"
        "b = manifest.benchmark()\n"
        "a = Namespace(workload=%r, seed=3, seconds=0.1, trace=1)\n"
        "out = run.result(b, a, 'cpu', time.perf_counter(), shape=(48, 48))\n"
        "assert 'pydem_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules(), out['correct'])\n" % (str(ROOT),
                                                             CELLS[0]))
    p = _python(code, ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split()[-2:] == ["[]", "True"]


def test_forbidden_names_compare_whole(monkeypatch):
    """``pydem_tpu_torch`` begins with the JAX package's name and is not
    it; a submodule of a forbidden package counts."""
    for name in list(sys.modules):
        if name.split(".")[0] in runner.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pydem_tpu_torch.fake", type(sys)("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", type(sys)("x"))
    monkeypatch.setitem(sys.modules, "pydem_tpu.fake", type(sys)("x"))
    assert runner.forbidden_modules() == ["jaxlib", "pydem_tpu"]


def test_reference_imports_no_program():
    ref = manifest.HERE / "reference"
    for path in ref.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in {"__future__", "numpy", "scipy",
                                           "torch"}, (path.name, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import hydrobench.reference.terrain\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'pydem_tpu', 'pydem_tpu_torch'}))" % str(ROOT))
    p = _python(code, ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "hydrobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from argparse import Namespace\n"
            "from hydrobench import manifest, run\n"
            "a = Namespace(workload=%r, seed=3, seconds=0.1, trace=0)\n"
            "print(run.result(manifest.benchmark(), a, 'cpu', 0.0, "
            "shape=(48, 48)))\n" % (str(tmp_path), CELLS[0]))
    p = _python(code, tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "pydem_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "hydrobench/run.py", "--workload",
                        CELLS[-1], "--seed", "5", "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
