"""Run one cell of the benchmark and print its result line.

    python3 hydrobench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``pydem_tpu_torch``).  It needs as many CUDA cards as the cell
asks for and fails without them: there is no CPU fallback.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number of the output check beside
its limit, which also close standard error.  Build and kernel caches stay
inside the checkout; the profiler's trace goes to ``TMPDIR`` and is
deleted once read.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pydem_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``pydem_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result(bench, args, device, t_start, shape=None):
    """The result dict of one run on ``device`` (``shape`` shrinks the
    tile for a rehearsal on the CPU), ``checks`` last."""
    import torch

    from hydrobench import geo, harness

    run, kept, pool, order = harness.run(bench, args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         device, t_start, shape=shape)
    cuda = torch.device(device).type == "cuda"
    out = {"correct": None, "attempted": len(run.tiles), "failed": 0,
           "metrics": harness.metrics(bench, run, bool(args.trace)),
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda
                      else "cpu", "count": 1,
                      "memory_peak_bytes": run.peak_bytes}}
    if args.trace:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    run.trace = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, checks, _ = harness.compare(run.config, kept, pool, order,
                                    geo.tile_spacings(run.config), device)
    out["correct"] = bool(ok)
    out["window_s"] = run.window_s
    out["check_s"] = time.perf_counter() - t_check
    out["power_limit"] = power_limit() if cuda else None
    out["checks"] = checks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".hydrobench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from hydrobench import manifest

    bench = manifest.benchmark(ROOT)
    workload = manifest.cell(bench, args.workload)[0]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < workload["chips"]:
        print("hydrobench: %s needs %d CUDA card(s), found %d"
              % (args.workload, workload["chips"], found), file=sys.stderr)
        return 2
    out = result(bench, args, torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print("hydrobench: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    print("card: %s; %d tiles in %.3f s; check %.1f s"
          % (out["power_limit"], out["attempted"], out["window_s"],
             out["check_s"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print("check %s = %r (limit %r)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
