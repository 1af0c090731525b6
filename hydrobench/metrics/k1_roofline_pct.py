"""The UCA solve's share of its memory roofline, %: the bytes a solve
needs, counted once a solve whatever its rounds (13 B a pixel of the
unpadded tile, ``roofline.k1_solve_bytes``), over 3.35 TB/s, divided by
the device time of every kernel launched inside the solver's spans in the
profiler trace, over the solves the trace holds.  It reads the same work
whatever implements the solve."""

from .. import roofline


def read(run):
    if run.trace is None:
        return None
    busy, solves = run.trace.kernel_s_in("uca_solve")
    if not busy:
        return None
    rows, cols = run.config["shape"]
    return 100.0 * solves * roofline.k1_bound_s(rows, cols) / busy
