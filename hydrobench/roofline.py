"""Peaks of the card and the work a kernel needs, for roofline shares.

Published figures of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W; the run prints the card's power limit beside them).
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12

# K1 solve: per pixel of the unpadded tile, once per solve whatever the
# rounds: a 1-byte receiver code, a 4-byte proportion and 4 bytes of base
# area in, 4 bytes of area out.  Its 2 multiply-adds a pixel are far below
# the compute peak, so bytes bound it.
K1_BYTES_PER_PX = 1 + 4 + 4 + 4


def k1_solve_bytes(rows, cols):
    return K1_BYTES_PER_PX * rows * cols


def k1_bound_s(rows, cols):
    """The least time one solve of a ``rows`` x ``cols`` tile could take."""
    return k1_solve_bytes(rows, cols) / HBM_BYTES_S
