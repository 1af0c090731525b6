"""``BENCHMARK.json`` and the data files it names, found by name.

A cell names a configuration and a traffic mix; the configuration names
its entry adapter (``entries/<entry>.py``), the traffic its terrain
generator (``terrain/<kind>.py``); every metric is read by
``metrics/<name>.py``.  Nothing here lists them: a later cell, mix,
configuration or metric is new files and new entries only.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench, name):
    """``(workload entry, config file, traffic file)`` of a cell."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / ("%s.json" % w["traffic"]))
    return w, config, traffic


def metrics_of(bench, workload, traced):
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones untraced, the per-layer ones traced; each only where its
    ``workloads`` list, if it has one, names the cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def module(package, name):
    """``hydrobench.<package>.<name>``; a name's ``-`` reads as ``_``."""
    return importlib.import_module("hydrobench.%s.%s"
                                   % (package, name.replace("-", "_")))
