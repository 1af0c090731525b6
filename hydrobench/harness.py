"""One run of a cell: set-up, the measured window, the output check.

The work is a closed loop of one worker over a directory of tiles: each
tile starts as elevation in host memory and ends with its products in host
memory and the device synchronised, and the next starts then.  The window
opens after set-up and closes with the tile that is running when
``seconds`` have passed: that tile completes and counts, and the window
ends with it.  Set-up is everything before: ``import torch``, loading the
program's built kernels, making the tile pool and one warm tile.
"""
from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field

import torch

from . import check, geo, manifest
from . import trace as tr

# A traced run's profiler covers the window's first TRACE_S seconds (to the
# end of the tile running then): reading a longer trace takes longer than
# a run may last.  The spans cover the whole window.
TRACE_S = 5.0


@dataclass
class Tile:
    latency_s: float
    pixels: int
    counters: dict


@dataclass
class Run:
    """What the metric readers read."""
    workload: dict
    config: dict
    setup_s: float
    tiles: list = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    spans: list = None  # {span: ms} a tile, traced runs only
    trace: object = None  # trace.Trace, traced runs only


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample_positions(seed, pool, count):
    """Window positions whose outputs are checked: distinct positions of
    the first pass over the pool, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(pool), min(count, pool)))


def run(bench, name, seed, seconds, traced, device, t_start, shape=None):
    """``(Run, kept planes {position: planes}, pool, order)``."""
    workload, config, traffic = manifest.cell(bench, name)
    if shape is not None:  # a rehearsal on the CPU at a small size
        config = dict(config, shape=list(shape))
    device = torch.device(device)
    spacing = geo.tile_spacings(config)
    entry_mod = manifest.module("entries", config["entry"])
    terrain = manifest.module("terrain", traffic["terrain"]["kind"])
    pool, order = terrain.make_pool(traffic, config, seed, device)
    entry = entry_mod.Entry(config, spacing, device)
    entry.run(pool[order[0]])  # warm: the cell's one tile shape
    _sync(device)
    sample = sample_positions(seed, len(pool), config["check"]["tiles"])

    spans = tr.Spans(device) if traced else None
    prof = tr.Profiler(device) if traced else None
    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(tr.wrapped(spans, entry_mod.SPANS))
            prof.start()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = Run(workload, config, setup_s=t0 - t_start)
        kept = {}
        i = 0
        while True:
            tile = pool[order[i % len(pool)]]
            a = time.perf_counter()
            planes, counters = entry.run(tile, keep=i in sample)
            _sync(device)
            b = time.perf_counter()
            out.tiles.append(Tile(b - a, int(tile.size), counters))
            if i in sample:
                kept[i] = planes
            if traced:
                spans.end_tile()
                if prof.running and b - t0 >= min(seconds, TRACE_S):
                    prof.stop()
            i += 1
            if b - t0 >= seconds:
                break
        out.window_s = b - t0
        if device.type == "cuda":
            out.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if traced:
        out.spans = spans.tiles
        out.trace = tr.Trace(prof.events)
    # a drawn position the window did not reach (only a window shorter
    # than one pass over the pool leaves one) runs now, on the same path
    for pos in sample:
        if pos not in kept:
            kept[pos] = entry.run(pool[order[pos]], keep=True)[0]
    return out, kept, pool, order


def compare(config, kept, pool, order, spacing, device):
    """The output check once the window has closed: each kept tile's
    planes against the float64 reference, computed on ``device``.
    ``(correct, checks, per-tile numbers)``."""
    ref = manifest.module("reference", config["reference"]) if kept else None
    per_tile = []
    for pos, planes in sorted(kept.items()):
        want = ref.planes(pool[order[pos % len(pool)]], spacing, config,
                          device)
        per_tile.append(check.numbers(planes, want,
                                      config["check"]["river_cells"]))
        del want
    ok, checks = check.judge(check.worst(per_tile),
                             config["check"]["limits"])
    return ok, checks, per_tile


def metrics(bench, run_, traced):
    """``{name: {"value", "unit"}}`` of the cell's metrics that have a
    reading."""
    out = {}
    for m in manifest.metrics_of(bench, run_.workload["name"], traced):
        value = manifest.module("metrics", m["name"]).read(run_)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
