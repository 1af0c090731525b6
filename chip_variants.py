#!/usr/bin/env python3
"""Time variants of the UCA block kernels against the shipped source, in one
process on one NVIDIA GPU, so that the numbers can be compared.

    python3 chip_variants.py [--other LABEL=path/to/uca_block.cu ...]

The variants are the shipped ``pydem_tpu_torch/ops/csrc/uca_block.cu``
("final") and copies of it with one design decision changed by text
substitution: "noskip" recomputes every strip in every sweep (no in-block
activity skip), "R4" gives a thread 4 rows instead of 8 (1024 threads a
block at B = 64), "R4noskip" both.  ``--other`` adds any source with the same
C interface, for example an earlier commit's
(``git show COMMIT:pydem_tpu_torch/ops/csrc/uca_block.cu > old.cu``).

Each variant is built with the package's own flags and run in turns (others,
final, noskip, R4, R4noskip, then the same backwards) on the 2048² cone and
hard terrain of ``chip_smoke.py``: the first K1 and K2 round at B = 64 (every
block visited), the K1 cone solve with the kernel time summed over its
launches, and the pit solves (K1 with the fold, K2) on the conditioned hard
terrain's planes and pit links.  Every variant must give the first variant's
results bit for bit.  Then, on the shipped source, the cone solve with the
flags read every 1, 4 and 8 rounds, and ``compact_from_dense`` alone.
All times are CUDA events, median of 5 after a warm-up, reps shown.
"""
import argparse
import os
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from pydem_tpu_torch.ops import _build
from pydem_tpu_torch.ops import uca_block as ub

SKIP_TEST = "if (__any_sync(0xffffffffu, poll && f_rd[qr * S::SC + qc])) {"
ROWS = "static constexpr int R = (B >= 64) ? 8 : 4;"
N, B = 2048, 64


def variant_sources(others):
    final = (_build.CSRC / "uca_block.cu").read_text()
    if SKIP_TEST not in final or ROWS not in final:
        raise SystemExit("chip_variants: the shipped source no longer holds "
                         "the lines the variants replace")
    noskip = final.replace(SKIP_TEST, "if (true) {")
    four = "static constexpr int R = 4;"
    derived = {"final": final, "noskip": noskip,
               "R4": final.replace(ROWS, four),
               "R4noskip": noskip.replace(ROWS, four)}
    sources = {label: Path(path).read_text() for label, path in others}
    sources.update(derived)
    order = [label for label, _path in others] + list(derived)
    return sources, order + order[::-1]


def use(label, source, scratch):
    """Build ``source`` and make it the library the wrappers launch."""
    where = Path(scratch) / label
    where.mkdir(parents=True, exist_ok=True)
    (where / "uca_block.cu").write_text(source)
    _build.CSRC = where
    _build.load.cache_clear()
    ub._kernel.cache_clear()
    _path, _seconds, log = _build.build("uca_block")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(label, line.strip())


def timed(label, what, fn, card, results):
    out = []
    ms, reps = cs.cuda_median_ms(lambda: out.append(fn()), reps=5)
    cs.log(label, "%s: median %.3f ms, reps %s ms [%s]"
           % (what, ms, ["%.3f" % t for t in reps], card))
    got = [t for t in out[-1] if isinstance(t, torch.Tensor)]
    want = results.setdefault(what, got)
    cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
             "%s: %s differs from the first variant's result" % (label, what))
    return out[-1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        metavar="LABEL=PATH")
    others = [o.split("=", 1) for o in parser.parse_args().other]
    card = cs.phase_device()
    device = torch.device("cuda", 0)
    shipped = _build.CSRC
    sources, order = variant_sources(others)

    state = {}
    for name, elev in (("cone", cs.make_cone(N)),
                       ("hard", cs.make_hard_terrain(N, "float32"))):
        W, base = cs.weights_and_base(torch.from_numpy(elev).to(device))
        state[name] = (W.contiguous(), base) + ub.compact_from_dense(W)
    pW, pbase, links = cs.chain_state(cs.make_hard_terrain(N), device)
    prev = torch.ones((N // B,) * 2, dtype=torch.int32, device=device)
    kw = dict(B=B, inner_max=2 * B + 4)

    results = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(shipped)) as scratch:
        for label in order:
            use(label, sources[label], scratch)
            for name, (W, base, K, W1) in state.items():
                timed(label, "%s first K1 round" % name,
                      lambda: ub.gs_round(base, K, W1, base, prev, **kw),
                      card, results)
                timed(label, "%s first K2 round" % name,
                      lambda: ub.block_round(base, W, base, **kw), card,
                      results)
            W, base, _K, _W1 = state["cone"]
            cs.log(label, "the K1 cone solve, next three lines:")
            cs.time_k1_solve(base, W, B, card)
            timed(label, "pit solve K1 + fold",
                  lambda: ub.accumulate_blocked_pits_gs(pbase, pW, *links),
                  card, results)
            timed(label, "pit solve K2",
                  lambda: ub.accumulate_blocked_pits(pbase, pW, *links),
                  card, results)

        use("final", sources["final"], scratch)
        shipped_per_read = ub.ROUNDS_PER_READ
        for per_read in (1, 4, 8, 8, 4, 1):
            ub.ROUNDS_PER_READ = per_read
            timed("final", "cone solve, flags read every %d rounds"
                  % per_read,
                  lambda: ub.accumulate_blocked_gs(base, W, B=B), card,
                  results)
        ub.ROUNDS_PER_READ = shipped_per_read
        timed("final", "compact_from_dense",
              lambda: ub.compact_from_dense(W), card, results)
    print("chip_variants: done")


if __name__ == "__main__":
    main()
