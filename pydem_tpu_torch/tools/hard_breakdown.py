"""Per-stage timing of the hard-terrain device chain.

Counterpart of ``tools/hard_breakdown.py``: ``DEMProcessor`` with the
device backends (``conditioning_backend="device", pit_backend="device"``,
the blocked solver) on the hard terrain, cut at its stage boundaries (the
API's stage probe, ``api._stage_probe``) with the device synchronised at
each one, so that each stage's cost is its own.  The forced
synchronisations cost what the unsynchronised chain does not pay, so the
sum of the stages may differ from the chain's own time: each rep runs the
chain once cut into stages and then once without the cuts, and prints the
two and their ratio.  This is a diagnostic, not a bench.

Clocks: a stage whose work is queued on the card (uploads, downloads and
kernels, with the host reads inside them) is timed with CUDA events; a
stage of host work (the C++ carve, the carve's diff) with the host clock.
Every stage says which.  On the CPU every stage is host clock.  One warm-up
rep, then ``--reps`` timed reps (at least 3) on the same terrain; every rep
is printed, and the median.

Run: ``python -m pydem_tpu_torch.tools.hard_breakdown [--n 1024] [--reps 3]
[--device cpu]`` (on the GPU unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import statistics
import time
import warnings

import numpy as np

# probe name -> (label, clock): the stage that ends at that probe
STAGES = {
    "elev_upload": ("elev upload", "device"),
    "fill_flats_device": ("fill_flats_device", "device"),
    "pit_gate": ("pit gate (one scalar read)", "device"),
    "carve_download": ("carve: download canvas", "device"),
    "carve_host_kernel": ("carve: native host kernel", "host"),
    "carve_delta_upload": ("carve: diff + changed pixels up", "host"),
    "pre_program": ("pre-program (slope+flats+section)", "device"),
    "pit_links": ("pit links (incl. host reads)", "device"),
    "uca_solve": ("UCA solve (blocked, pit fold)", "device"),
    "twi_program": ("twi program", "device"),
    "twi_download": ("twi download", "device"),
}
CHAIN = dict(conditioning_backend="device", pit_backend="device",
             uca_solver="blocked")


def make_hard_terrain(n, dtype="float64"):
    """Quantized noisy cone: flats + pits from quantization, plus a masked
    below-sea region (the reference's hard-terrain regimes)."""
    rng = np.random.RandomState(7)
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = 1 - np.sqrt(x**2 + y**2) / np.sqrt(2.0) + rng.randn(n, n) * 0.002
    elev = np.round(elev * 150) / 150  # quantization flats/pits
    elev = elev - elev.min() + 0.05
    elev[(x > 0.8) & (np.abs(y) < 0.1)] = 0.0  # sea notch
    return elev.astype(dtype)


class StageClock:
    """The API's stage probe: at each boundary, an event on the card, a
    synchronisation and the host clock."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []

    def __call__(self, name, _val=None):
        import torch

        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            torch.cuda.synchronize(self.device)
        self.marks.append((name, time.perf_counter(), ev))

    def stages(self):
        """[(probe name, label, clock, ms)] in the order run."""
        out = []
        for (_a, ta, ea), (b, tb, eb) in zip(self.marks, self.marks[1:]):
            label, clock = STAGES[b]
            if not self.cuda:
                clock = "host"
            ms = ea.elapsed_time(eb) if clock == "device" else (tb - ta) * 1e3
            out.append((b, label, clock, ms))
        return out


def run_chain(elev, device, clock=None, uca_solver="blocked"):
    """One ``calc_twi`` of the chain, with ``clock`` as the stage probe;
    returns the processor and the twi."""
    from .. import api

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "pits had no place to drain"
        dp = api.DEMProcessor(elev=elev.copy(), device=device,
                              **dict(CHAIN, uca_solver=uca_solver))
        api._stage_probe = clock
        try:
            if clock is not None:
                clock("start")
            twi = dp.calc_twi()
        finally:
            api._stage_probe = None
    return dp, twi


def chain_ms(elev, device):
    """The chain without synchronisations at its stages: CUDA events on
    the card, the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        run_chain(elev, device)
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_chain(elev, device)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def link_probe(device, reps=3):
    """Scalar round trip, 4 MB up and 4 MB down, host clock around a
    synchronisation; ms of each rep."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    a = np.random.default_rng(0).random((1024, 1024)).astype("float32")
    d = torch.as_tensor(a, device=device)
    probes = (("scalar round trip", lambda: float(d[0, 0] + 0)),
              ("upload 4 MB", lambda: torch.as_tensor(a, device=device)),
              ("download 4 MB", lambda: (d + 1).cpu()))
    out = {}
    for label, fn in probes:
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = ts
        print("  %-22s %s ms (host clock)"
              % (label, " ".join("%.3f" % t for t in ts)), flush=True)
    return out


def breakdown(n=1024, reps=3, device="cuda"):
    """The chain at ``n``², a warm-up then ``reps`` timed reps, each the
    chain cut into stages and then the chain without the cuts; prints every
    rep and the medians.  Returns ``{"stages": {label: {"clock", "reps",
    "median"}}, "sum", "chain", "ratio": {"reps", "median"},
    "uca_rounds"}``: ``sum`` the stages' sum, ``chain`` the uncut chain,
    ``ratio`` each rep's sum over its chain."""
    import torch

    if reps < 3:
        raise ValueError("reps must be at least 3, got %d" % reps)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hard_breakdown(device=%r): torch.cuda is not "
                           "available (--device cpu runs on the CPU)"
                           % str(device))
    elev = make_hard_terrain(n)
    print("-- link probe (%s) --" % device, flush=True)
    link_probe(device)
    runs, chain = [], []
    for rep in range(reps + 1):
        clock = StageClock(device)
        dp, _twi = run_chain(elev, device, clock)
        uncut = chain_ms(elev, device)
        if rep:  # rep 0 warms up
            runs.append(clock.stages())
            chain.append(uncut)
    order = [(name, label, clk) for name, label, clk, _ms in runs[0]]
    for r in runs[1:]:
        if [s[0] for s in r] != [s[0] for s in runs[0]]:
            raise RuntimeError("the chain's stages differ between reps")
    stages = {}
    print("-- hard terrain %d², %s, %d timed reps --" % (n, device, reps),
          flush=True)
    for i, (_name, label, clk) in enumerate(order):
        ms = [r[i][3] for r in runs]
        stages[label] = {"clock": clk, "reps": ms,
                         "median": statistics.median(ms)}
        print("  %-36s %-6s median %9.3f ms, reps %s" % (
            label, clk, stages[label]["median"],
            " ".join("%.3f" % t for t in ms)), flush=True)
    sums = [sum(s[3] for s in r) for r in runs]
    ratio = [a / b for a, b in zip(sums, chain)]
    out = {"stages": stages, "uca_rounds": int(dp.uca_sweeps)}
    for key, ms in (("sum", sums), ("chain", chain), ("ratio", ratio)):
        out[key] = {"reps": ms, "median": statistics.median(ms)}
    print("  %-36s %-6s median %9.3f ms, reps %s" % (
        "TOTAL (sum of synced stages)", "mixed", out["sum"]["median"],
        " ".join("%.3f" % t for t in sums)), flush=True)
    print("  %-36s %-6s median %9.3f ms, reps %s" % (
        "chain without stage syncs", "device" if device.type == "cuda"
        else "host", out["chain"]["median"],
        " ".join("%.3f" % t for t in chain)), flush=True)
    print("  %-36s %-6s median %9.3f, reps %s" % (
        "sum / chain, rep by rep", "", out["ratio"]["median"],
        " ".join("%.3f" % r for r in ratio)), flush=True)
    print("  uca rounds: %d" % out["uca_rounds"], flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-stage timing of the "
                                             "hard-terrain device chain")
    ap.add_argument("--n", type=int, default=1024, help="canvas side")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed reps after one warm-up (at least 3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the "
                         "CPU)")
    args = ap.parse_args(argv)
    return breakdown(args.n, args.reps, args.device)


if __name__ == "__main__":
    main()
