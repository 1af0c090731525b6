"""The exactness argument of the cluster visit with ghost rows, on the CPU.

At B = 128 and 256 the CUDA kernels relax one block on a thread-block
cluster of C CTAs, each owning a band of B / C rows, and swap the bands'
edge rows after every sweep.  A ghost-row visit, measured on the card and
not kept there (slower than the per-sweep exchange; ``PERF.md``), keeps
G = 4 ghost rows of each neighbouring band in a band's windows.  In sweep s = 0..3 of a 4-sweep group a band computes
itself and 3 - s ghost rows on each side with a neighbour; at the group's
end the bands swap their first and last G rows and edge strips' changed
flags, and the next group copies them into both windows; the strip-activity
skip runs on strips of 8 rows by 32 columns, the ghost strips included.

:func:`cluster_visit` emulates that schedule in torch, band by band in
lockstep (the emulation lives here only, not in the package), and the tests
hold it against the plain visit (``ops.uca_block._relax_blocks`` on one
block), bit for bit, in float32 and float64, on windows of a cone and of the
hard terrain (conditioned), for a visit that stops on the vote and one that reaches
``inner_max``.  The card holds the kernels against the plain version
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import functools
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pydem_tpu_torch.api import DEMProcessor
from pydem_tpu_torch.core.receivers import receiver_weights
from pydem_tpu_torch.core.stencil import NEIGHBOR_OFFSETS
from pydem_tpu_torch.core.uca import base_area
from pydem_tpu_torch.ops import uca_block as t_ub
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.tools.hard_breakdown import make_hard_terrain

torch.set_num_threads(1)

G, GC = 4, 3     # ghost rows a side, and those computed
SH, LW = 8, 32   # a strip: one warp's 8 rows by 32 columns
CLUSTER = {128: 4, 256: 16}


def _strip_any(a, rows, SC):
    """(C, len(rows), B) bool -> (C, SC): any within each 32-column strip
    of those rows."""
    return a[:, rows].reshape(a.shape[0], len(rows), SC, LW).any(3).any(1)


def cluster_visit(xw, wk, base, inner_max):
    """One block visit with ghost rows, band by band: ``xw`` the (B+2)²
    window with its frozen halo, ``wk`` the (8, B, B) incoming weights
    (``wk[k]`` from the source p - o_k), ``base`` (B, B).  Returns ``(block,
    sweeps)``."""
    B = base.shape[0]
    C = CLUSTER[B]
    BR = B // C
    WR, SR, SC = BR + 2 * G, BR // SH, B // LW
    dt = xw.dtype
    # window row wr of band c is block row c*BR - G + wr (-1, B: the halo)
    cur = torch.zeros((C, WR, B + 2), dtype=dt)
    w = torch.zeros((8, C, WR, B), dtype=dt)
    bse = torch.zeros((C, WR, B), dtype=dt)
    for c in range(C):
        for wr in range(WR):
            gi = c * BR - G + wr
            if -1 <= gi <= B:
                cur[c, wr] = xw[gi + 1]
            if 0 <= gi < B:
                w[:, c, wr] = wk[:, gi]
                bse[c, wr] = base[gi]
    nxt = cur.clone()
    above = torch.arange(C) > 0
    below = torch.arange(C) < C - 1
    f_rd = torch.ones((C, SR + 2, SC), dtype=torch.bool)
    f_rd[~above, 0] = False
    f_rd[~below, SR + 1] = False
    f_wr = torch.zeros_like(f_rd)
    band_rows = [list(range(G + a * SH, G + (a + 1) * SH)) for a in range(SR)]
    land = lflags = None
    it, changed = 0, True
    while it < inner_max and changed:
        if it > 0:  # the landing rows into both windows, flags beside
            for t in (cur, nxt):
                t[above, :G, 1:-1] = land[0][above]
                t[below, G + BR:, 1:-1] = land[1][below]
            f_rd[above, 0] = lflags[0][above]
            f_rd[below, SR + 1] = lflags[1][below]
        for s in range(4):
            acc = bse[:, 1:-1].clone()
            for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                acc = acc + w[k, :, 1:-1] * cur[:, 1 - di: WR - 1 - di,
                                                1 - dj: B + 1 - dj]
            acc = F.pad(acc, (0, 0, 1, 1))  # rows of the whole window
            old = cur[:, :, 1:-1]
            # a strip runs if a strip of its 3x3 neighbourhood changed
            active = F.max_pool2d(f_rd[:, None].to(dt), 3, 1, 1)[:, 0] > 0
            # (flag row, window rows, bands) of every strip computed now
            strips = [(a + 1, band_rows[a], torch.ones(C, dtype=torch.bool))
                      for a in range(SR)]
            if s < 3:
                ng = GC - s
                strips += [(0, list(range(G - ng, G)), above),
                           (SR + 1, list(range(G + BR, G + BR + ng)), below)]
            f_wr.zero_()
            for a, rows, bands in strips:
                run = active[:, a] & bands[:, None]  # (C, SC)
                mask = run.repeat_interleave(LW, 1)[:, None, :]
                new = torch.where(mask, acc[:, rows], nxt[:, rows, 1:-1])
                f_wr[:, a] = _strip_any((acc[:, rows] != old[:, rows])
                                        & mask, range(len(rows)), SC)
                nxt[:, rows, 1:-1] = new
            cur, nxt = nxt, cur
            f_rd, f_wr = f_wr, f_rd
        changed = bool(f_rd[:, 1: SR + 1].any())  # the 4th sweep's vote
        # each band's first G rows to the band above, its last G below
        land = (torch.roll(cur[:, BR: G + BR, 1:-1], 1, 0),
                torch.roll(cur[:, G: 2 * G, 1:-1], -1, 0))
        lflags = (torch.roll(f_rd[:, SR], 1, 0), torch.roll(f_rd[:, 1], -1, 0))
        it += 4
    return cur[:, G: G + BR, 1:-1].reshape(B, B), it


def plain_visit(xw, W, base, inner_max):
    """The plain visit of the same block: ``_relax_blocks`` on its ringed
    window.  Returns the block."""
    B = base.shape[0]
    out, _chg = t_ub._relax_blocks(xw, W, base, torch.ones((1, 1),
                                                           dtype=torch.bool),
                                   B=B, inner_max=inner_max, ring=True)
    return out[1:-1, 1:-1]


def _cone(n):
    i, j = np.mgrid[:n, :n]
    return -np.hypot(i - n / 2 + 0.5, j - n / 2 + 0.5)


@functools.lru_cache(maxsize=None)
def _planes(kind, n):
    """Receiver planes and base (float64) of the n² cone, or of the hard
    terrain conditioned as the device chain solves it (flats filled, pits
    carved: its raw planes end most paths within a few pixels)."""
    if kind == "cone":
        elev = torch.from_numpy(_cone(n))
        ones = [torch.ones(n - 1, dtype=elev.dtype)] * 2 \
            + [torch.ones(n, dtype=elev.dtype)] * 2
        _m, _d, _f, W, base = sharded.terrain_pre(elev, *ones)
        return W, base
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = DEMProcessor(elev=make_hard_terrain(n), device="cpu",
                          conditioning_backend="device", pit_backend="device")
        dp._slopes_device()
        elev = dp._dev("elev")
        W = receiver_weights(dp._dev("section"), dp._dev("proportion"), elev)
        base = base_area(dp._to_dev(dp.dX2), dp._to_dev(dp.dY2), elev.shape,
                         elev.dtype)
    return W, base


def _window(kind, B, dtype):
    """A (B+2)² window of a 2B-wide terrain's receiver planes around block
    (1, 1), its halo the neighbours' pixels and the canvas's zero pad, the
    canvas starting at its base: ``(xw, W, wk, base)``."""
    W, base = (t.to(dtype) for t in _planes(kind, 2 * B))
    xw = F.pad(base, (1, 1, 1, 1))[B: 2 * B + 2, B: 2 * B + 2].contiguous()
    Wr = F.pad(W, (1, 1, 1, 1))[:, B: 2 * B + 2, B: 2 * B + 2].contiguous()
    wk = torch.stack([Wr[k, 1 - di: 1 - di + B, 1 - dj: 1 - dj + B]
                      for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS)])
    return xw, Wr, wk, base[B:, B:].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["cone", "hard"])
@pytest.mark.parametrize("B", [128, 256])
def test_cluster_visit_equals_plain_to_the_vote(B, kind, dtype):
    """The default ``inner_max`` (2B + 4): the visit stops on the vote."""
    xw, W, wk, base = _window(kind, B, dtype)
    inner_max = 2 * B + 4
    got, sweeps = cluster_visit(xw, wk, base, inner_max)
    assert sweeps < inner_max
    want = plain_visit(xw, W, base, inner_max)
    assert not torch.equal(want, xw[1:-1, 1:-1])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["cone", "hard"])
@pytest.mark.parametrize("B", [128, 256])
def test_cluster_visit_equals_plain_at_inner_max(B, kind, dtype):
    """A cap of 12 sweeps, which the visit reaches before its fixed
    point."""
    xw, W, wk, base = _window(kind, B, dtype)
    got, sweeps = cluster_visit(xw, wk, base, 12)
    assert sweeps == 12
    want = plain_visit(xw, W, base, 12)
    assert not torch.equal(want, plain_visit(xw, W, base, 16))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
