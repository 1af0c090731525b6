"""Mean ms a tile of the UCA solve: CUDA events around the blocked
solver's call (``uca_block.accumulate_blocked_gs``, or its pit form)."""

from . import span_mean


def read(run):
    return span_mean(run, "uca_solve")
