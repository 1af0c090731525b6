"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and new entries only, in a copy: the harness finds them by name
and no file it had changes."""
import hashlib
import json
import shutil
import subprocess
import sys

from hydrobench import manifest

ROOT = manifest.ROOT


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    hb = tmp_path / "hydrobench"
    shutil.copytree(manifest.HERE, hb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(hb)

    cfg = manifest.load_json(manifest.HERE / "configs"
                             / "merit-hydro-6000.json")
    cfg.update(name="tiny-merit", shape=[40, 40])
    (hb / "configs" / "tiny-merit.json").write_text(json.dumps(cfg))
    (hb / "traffic" / "tiny-ridge.json").write_text(json.dumps({
        "why": "a test mix", "pool": 2, "terrain": {
            "kind": "fractal", "surface_seed": 4, "hurst": 0.5,
            "relief_m": 50, "tilt_m": 5,
            "base_m": 10, "fill_eps_m": 0.01}}))
    (hb / "metrics" / "tiles_done.py").write_text(
        "def read(run):\n    return len(run.tiles)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-merit", "source": "a test",
                             "file": "hydrobench/configs/tiny-merit.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-merit",
                               "traffic": "tiny-ridge", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tiles_done", "unit": "tiles",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "tile_mpx_s",
                               "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import sys, time, json; sys.path.insert(0, %r); "
            "sys.path.append(%r)\n"
            "from argparse import Namespace\n"
            "from hydrobench import manifest, run\n"
            "assert manifest.HERE == manifest.ROOT / 'hydrobench'\n"
            "assert str(manifest.ROOT) == %r\n"
            "b = manifest.benchmark()\n"
            "out = {}\n"
            "for t in (0, 1):\n"
            "    a = Namespace(workload='tiny-cell', seed=9, seconds=0.2, "
            "trace=t)\n"
            "    out[t] = run.result(b, a, 'cpu', time.perf_counter())\n"
            "print(json.dumps(out))\n" % (str(tmp_path), str(ROOT),
                                          str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["0"]["correct"] and out["1"]["correct"]
    assert out["0"]["metrics"]["tile_mpx_s"]["value"] > 0
    assert out["1"]["metrics"]["tiles_done"]["value"] == out["1"]["attempted"]
    after = _digests(hb)
    assert {k: after[k] for k in before} == before
