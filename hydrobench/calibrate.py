"""Readings for the output check's limits, on the card, in one process.

    python3 hydrobench/calibrate.py --workload <cell> --seeds 1 2 ...
        [--control 3] [--out FILE]

For each seed: the tiles a run of that seed checks (the pool is every
seed's; the seed draws the order), run through the entry as the window
runs them (after one warm tile), and their numbers against the float64
reference: the program's readings (a tile drawn again is read once).
For the first ``--control`` seeds the same numbers of the reference
computed in bfloat16 in the program's place: the control's readings.
One JSON line a seed and kind, then the largest program reading and the
smallest control reading of each number.  The limits in a config's
``check`` block are set between the two (PERF.md gives both).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hydrobench import check, geo, harness, manifest

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = manifest.benchmark(ROOT)
    _w, config, traffic = manifest.cell(bench, args.workload)
    spacing = geo.tile_spacings(config)
    entry_mod = manifest.module("entries", config["entry"])
    terrain = manifest.module("terrain", traffic["terrain"]["kind"])
    ref = manifest.module("reference", config["reference"])
    pool, _ = terrain.make_pool(traffic, config, args.seeds[0], dev)
    entry = entry_mod.Entry(config, spacing, dev)
    entry.run(pool[0])  # warm
    out = open(args.out, "a") if args.out else None
    worst = {"program": {}, "control": {}}
    seen = {}  # pool index -> {kind: numbers}: the pool is every seed's
    for k, seed in enumerate(args.seeds):
        order = terrain.pool_order(len(pool), seed, dev)
        kinds = ["program"] + (["control"] if k < args.control else [])
        for pos in harness.sample_positions(seed, len(pool),
                                            config["check"]["tiles"]):
            idx = order[pos]
            done = seen.setdefault(idx, {})
            if any(kind not in done for kind in kinds):
                tile = pool[idx]
                planes, counters = entry.run(tile, keep=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want = ref.planes(tile, spacing, config, dev)
                t_ref = time.perf_counter() - t1
                for kind in kinds:
                    got = planes if kind == "program" else {
                        key: v for key, v in ref.planes(
                            tile, spacing, config, dev,
                            torch.bfloat16).items() if key in planes}
                    done[kind] = dict(numbers=check.numbers(
                        got, want, config["check"]["river_cells"]),
                                      counters=counters, ref_s=t_ref)
                del want, planes
                torch.cuda.empty_cache()
            for kind in kinds:
                nums = done[kind]["numbers"]
                for key, v in nums.items():
                    w = worst[kind]
                    w[key] = (max if kind == "program" else min)(
                        w.get(key, v), v)
                line = json.dumps(dict(seed=seed, pos=pos, tile=idx,
                                       kind=kind, **done[kind]))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
    print(json.dumps({"workload": args.workload, "worst": worst}), flush=True)
    if out:
        out.write(json.dumps({"workload": args.workload, "worst": worst})
                  + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
