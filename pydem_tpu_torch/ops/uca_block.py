"""Block-resident UCA relaxation: the CUDA kernels' wrappers, their plain
PyTorch versions, and the round drivers.

Port of ``pydem_tpu/ops/uca_block.py``, both of its TPU kernels:

- K1, ``_gs_kernel``: compact receivers (``compact_from_dense``), a frontier
  skip, driven by ``accumulate_blocked_gs`` and, with pit links folded into
  the base every round, ``accumulate_blocked_pits_gs``;
- K2, ``_block_kernel``: the 8 dense weight planes, every block visited,
  driven by ``accumulate_blocked`` and ``accumulate_blocked_pits``.

The canvas is tiled into B×B blocks; one *round* relaxes blocks, each to its
local fixed point with its 1-px halo frozen, and reports a changed flag per
block.  Rounds repeat until no block changes; K1's solvers read the flags
on the host once per ``ROUNDS_PER_READ`` rounds, which changes neither the
canvas nor the round count they return (a round after a still round is a
no-op).

K1 runs in the TPU kernel's order.  The TPU visits its grid of blocks in
sequence, in place: each block reads the live canvas and so sees this
round's values of every block visited before it; rounds cycle through four
corner orientations (``_FLIPS``).  The grid is the whole block grid, or a
*subset*: the interior blocks, or the frame of rim blocks walked top row,
bottom row, then the two side columns (:func:`visit_sequence`).  From the
visit sequence each block has its *predecessors*, the halo neighbours of
the subset visited before it, at most ``MAX_PREDS`` (:func:`round_table`).
On the GPU the blocks of one launch run in no order, so
:func:`gs_round_oriented` runs a round as one persistent *dataflow* launch:
CTAs draw the blocks in a topological order from a ticket counter, and a
block relaxes only once each predecessor has published that it is done, so
it reads exactly what the sequential grid's block reads.  The round equals
the JAX ``gs_round_oriented`` round bit for bit, flags included.  Its plain
twin :func:`gs_round_oriented_plain` relaxes the blocks level by level (a
block's level is one more than its predecessors' highest,
:func:`round_levels`), each level's blocks together.

Three forms share the kernel: the *canvas* form, the *ring* form
(``ring=True``: a window of a larger canvas, an engine visit or a shard,
whose ``x``, ``K`` and ``W1`` carry a 1-px ring, read as the frozen halo
and never written; the ring of ``K``/``W1`` holds the ring pixels' real
receivers), and the *subset* forms (``subset="interior"`` or
``"boundary"`` on the ring form: the mesh's split round).  Every pixel's
sum is the rounding sequence of a whole-canvas round.  The solvers run the
JAX package's rounds: ``accumulate_blocked_gs`` and
``accumulate_blocked_pits_gs`` round r at orientation r % 4, the engine's
visit at ``(o0 + r) % 4`` (:func:`_in_turn`), the mesh's rounds at
``r % 4``, each at the same B and ``inner_max``.  The solvers default to
the TPU solvers' B = 256, and the callers take the JAX functions' rules
(256, or 128 on small canvases), so the defaults return the JAX package's
rounds.  The dataflow kernel and K2 are built for B ∈ ``KERNEL_BLOCKS``
(8, 16, 32, 64, 128, 256: every B the JAX package picks for a canvas or a
shard).  One 258² float32 window (266 KB) is more than an SM's 228 KB of
shared memory, so at B = 128 and 256 one block visit is relaxed by a
thread-block cluster of 4 or 16 CTAs, each owning a band of the block's
rows; after every sweep the bands send the rows next to each cut into
their neighbours' windows as asynchronous stores that the receiver's
mbarrier counts, with no barrier over the cluster
(:func:`kernel_cluster_size`); it computes what one CTA would, bit for
bit.

:func:`block_round`, K2's round, is block-Jacobi, as the TPU's
``_block_kernel`` is: every block reads the round-start canvas and writes a
new one.  :func:`gs_round_oriented` and :func:`block_round` launch their
kernel (``csrc/uca_block.cu``) for CUDA tensors and run their plain version
(:func:`gs_round_oriented_plain`, :func:`block_round_plain`) for CPU
tensors; the sweep probe :func:`probe_round` launches only.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import itertools

import torch
import torch.nn.functional as F

from ..core.stencil import NEIGHBOR_OFFSETS, dilate
from ..core.uca import PitLinks
from ..profiling import count, span

# Compact receiver encoding: every pixel has at most two nonzero outgoing
# weights (its D∞ facet pair), so the 8 dense planes compress to a packed
# index plane K = k1*16 + k2 (15 = "no edge"; stored as uint8, all-none is
# 255) plus one weight plane W1; the slot-2 weight is 1 - W1.
_NO_EDGE = 15
# block sizes the dataflow kernel (K1 in the TPU's order) and K2 are built
# for; at 128 and 256 a visit runs on a thread-block cluster
KERNEL_BLOCKS = (8, 16, 32, 64, 128, 256)


def compact_from_dense(W):
    """Compress dense (8, n, m) receiver planes to ``(K, W1)``; ``K`` uint8.

    Each pixel has ≤2 nonzero entries, and when two exist they are
    complementary (one computed as ``1.0 - other``).  The slots are ordered
    so that ``1 - W1`` reproduces the second weight bitwise.
    """
    shape = W.shape[1:]
    k1 = torch.full(shape, _NO_EDGE, dtype=torch.int32, device=W.device)
    k2 = torch.full_like(k1, _NO_EDGE)
    w1 = torch.zeros(shape, dtype=W.dtype, device=W.device)
    w2 = torch.zeros_like(w1)
    for k in range(8):
        wk = W[k]
        nz = wk != 0
        t1 = nz & (k1 == _NO_EDGE)
        k1 = torch.where(t1, k, k1)
        w1 = torch.where(t1, wk, w1)
        t2 = nz & ~t1 & (k2 == _NO_EDGE)
        k2 = torch.where(t2, k, k2)
        w2 = torch.where(t2, wk, w2)
    both = k2 != _NO_EDGE
    swap = both & (1 - w1 != w2) & (1 - w2 == w1)
    k1f = torch.where(swap, k2, k1)
    w1f = torch.where(swap, w2, w1)
    k2f = torch.where(swap, k1, k2)
    K = k1f * 16 + torch.where(both, k2f, _NO_EDGE)
    return K.to(torch.uint8), w1f


def expand_compact(K, W1):
    """Dense (8, n, m) weight planes from ``(K, W1)`` (inverse of
    :func:`compact_from_dense`)."""
    k1 = (K >> 4).to(torch.int32)
    k2 = (K & 15).to(torch.int32)
    w2 = torch.where(k2 != _NO_EDGE, 1 - W1, 0.0)
    return torch.stack([torch.where(k1 == k, W1, 0.0)
                        + torch.where(k2 == k, w2, 0.0) for k in range(8)])


def _check_canvas(x, B):
    n, m = x.shape
    if n % B or m % B:
        raise ValueError("canvas %dx%d is not a multiple of the block size %d"
                         % (n, m, B))


def _check_planes(x, named):
    """Every ``(name, tensor)`` in ``named`` has x's shape and float dtype."""
    for name, t in named:
        if tuple(t.shape[-2:]) != tuple(x.shape):
            raise ValueError("%s has shape %s, expected %s"
                             % (name, tuple(t.shape), tuple(x.shape)))
        if t.dtype != x.dtype:
            raise TypeError("%s is %s but x is %s" % (name, t.dtype, x.dtype))


def _check_round_args(x, K, W1, base, prev, B, ring=0):
    """K1's arguments; ``ring`` = 1 for the ring form, whose ``x``, ``K`` and
    ``W1`` are 2 px larger than ``base`` each way."""
    _check_canvas(base, B)
    n, m = base.shape
    if K.dtype != torch.uint8:
        raise TypeError("K must be uint8, got %s" % K.dtype)
    if prev.dtype != torch.int32:
        raise TypeError("prev must be int32, got %s" % prev.dtype)
    full = (n + 2 * ring, m + 2 * ring)
    for name, t in (("x", x), ("K", K)):
        if tuple(t.shape) != full:
            raise ValueError("%s has shape %s, expected %s"
                             % (name, tuple(t.shape), full))
    if tuple(prev.shape) != (n // B, m // B):
        raise ValueError("prev has shape %s, expected %s"
                         % (tuple(prev.shape), (n // B, m // B)))
    _check_planes(x, (("W1", W1),))
    if base.dtype != x.dtype:
        raise TypeError("base is %s but x is %s" % (base.dtype, x.dtype))


def _dirty(prev):
    """The blocks a K1 round relaxes: those whose 3×3 block neighbourhood
    has a nonzero flag."""
    return dilate(prev != 0)


def _check_block_args(x, W, base, B):
    _check_canvas(x, B)
    if W.dim() != 3 or W.shape[0] != 8:
        raise ValueError("W must hold 8 weight planes, got shape %s"
                         % (tuple(W.shape),))
    _check_planes(x, (("W", W), ("base", base)))


def _relax_blocks(x, W, base, dirty, *, B, inner_max, ring=False):
    """The sweep loop of the plain rounds.

    The ``dirty`` blocks ((n/B, m/B) bool) are cut out of the zero-padded
    canvas with their 1-px halo and relaxed together by Jacobi sweeps, 4 per
    convergence test, capped at ``inner_max``; the other blocks keep their
    values.  With ``ring``, ``x`` and ``W`` already carry a 1-px ring around
    the (n, m) region of ``base`` and take the zero pad's place: the ring is
    read and comes back as it was.  A block whose 4th sweep changed nothing is at its fixed point,
    so sweeping it on with the others is a bitwise no-op: the lockstep loop
    gives each block exactly the kernel's result.  ``W`` are the dense
    (8, n, m) weight planes (``W[k]`` sends along ``NEIGHBOR_OFFSETS[k]``).
    Returns ``(x_new, chg)`` with ``chg`` the (n/B, m/B) int32 changed flags.
    """
    n, m = base.shape
    nb_i, nb_j = n // B, m // B
    out = x.clone()
    chg = torch.zeros((nb_i, nb_j), dtype=torch.int32, device=x.device)
    if not bool(dirty.any()):
        return out, chg

    def windows(a, size, pad):  # (..., n, m) -> (..., nd, size, size)
        if pad:
            a = F.pad(a, (1, 1, 1, 1))
        w = a.unfold(-2, size, B).unfold(-2, size, B)
        return w[..., dirty, :, :]

    win = windows(x, B + 2, not ring)  # a copy: updated in place below
    w_in = windows(W, B + 2, not ring)
    bse = windows(base, B, False)
    # incoming weight of receiver p along k: source q = p - o_k
    w_k = [w_in[k, :, 1 - di: 1 - di + B, 1 - dj: 1 - dj + B]
           for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS)]
    interior = win[:, 1: B + 1, 1: B + 1]
    x0 = interior.clone()

    it = 0
    changed = True
    while it < inner_max and changed:
        for _ in range(4):
            acc = bse
            for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                acc = acc + w_k[k] * win[:, 1 - di: 1 - di + B,
                                         1 - dj: 1 - dj + B]
            moved = acc != interior
            interior.copy_(acc)  # Jacobi: write after the whole sweep read
        changed = bool(moved.any())
        it += 4

    region = out[1:-1, 1:-1] if ring else out
    blocks = region.view(nb_i, B, nb_j, B).permute(0, 2, 1, 3)
    blocks[dirty] = interior  # writes through the view into `out`
    chg[dirty] = (interior != x0).flatten(1).any(1).to(torch.int32)
    return out, chg


# The 4 corner visit orders of the TPU kernel's rounds (SE, NW, SW, NE):
# (flip rows, flip columns) of the row-major block grid, round r at r % 4.
_FLIPS = ((False, False), (True, True), (False, True), (True, False))


def _check_orientation(o):
    if isinstance(o, torch.Tensor):
        o = int(o)
    if o not in range(4):
        raise ValueError("orientation must be 0..3, got %r" % (o,))
    return int(o)


FORMS = ("all", "interior", "boundary")
# the most predecessors a block has in any form (see _order)
MAX_PREDS = 4


def _check_subset(subset, nb_i, nb_j):
    if subset not in FORMS:
        raise ValueError("subset must be one of %s, got %r" % (FORMS, subset))
    if subset != "all" and (nb_i < 3 or nb_j < 3):
        raise ValueError("subset rounds need a block grid of at least 3x3, "
                         "got %dx%d" % (nb_i, nb_j))


def visit_sequence(nb_i, nb_j, o, subset="all"):
    """The blocks of a K1 round in the order the TPU's sequential grid visits
    them, as flat indices ``bi * nb_j + bj`` (a list): the grid of
    ``subset`` (the JAX kernel's ``_subset_grid``) walked in order, each
    grid step mapped to its block and then through the flips of
    ``_FLIPS[o]``.  ``"all"``: the row-major block grid; ``"interior"``: the
    (nb_i-2) × (nb_j-2) row-major grid, one block in from the rim;
    ``"boundary"``: the frame walk, the top row, then the bottom row, then
    the two side columns interleaved row by row.  Grid step ``t`` of the
    boundary grid is the ``t``-th entry: the JAX kernel writes that block's
    flag at program id ``t``."""
    o = _check_orientation(o)
    _check_subset(subset, nb_i, nb_j)
    if subset == "all":
        steps = [(i, j) for i in range(nb_i) for j in range(nb_j)]
    elif subset == "interior":
        steps = [(i + 1, j + 1) for i in range(nb_i - 2)
                 for j in range(nb_j - 2)]
    else:
        steps = [(0, j) for j in range(nb_j)]
        steps += [(nb_i - 1, j) for j in range(nb_j)]
        steps += [(1 + s // 2, (s % 2) * (nb_j - 1))
                  for s in range(2 * (nb_i - 2))]
    fi, fj = _FLIPS[o]
    return [(nb_i - 1 - i if fi else i) * nb_j + (nb_j - 1 - j if fj else j)
            for i, j in steps]


@functools.cache
def _order(nb_i, nb_j, o, subset):
    """The dependencies of a K1 round in the TPU's order, from its visit
    sequence (:func:`visit_sequence`): ``(table, levels)``.

    A block's *predecessors* are its halo neighbours in the round's subset
    that the sequence visits before it: what the sequential grid has
    written, this round, of the halo the block reads.  Its level is one
    more than the highest level of its predecessors (0 for none).
    ``table``: (blocks, 1 + MAX_PREDS) int32, one row a block, sorted by
    level (stably: in visit order within a level), each row the block's
    flat index and its predecessors' (-1 past the last); so sorted, the
    rows are a topological order of the dependencies.  ``levels``:
    (nb_i, nb_j) int64, the level of each block of the subset, -1
    elsewhere.

    Row-major (``"all"``, ``"interior"``), a block at oriented coordinates
    (p, q) has (p-1, q-1), (p-1, q), (p-1, q+1) and (p, q-1) before it, and
    its level is 2p + q on grids two or more blocks wide.  The frame walk
    is not row-major: a bottom-row block precedes its side-column
    neighbours, so its levels come from the sequence alone."""
    seq = visit_sequence(nb_i, nb_j, o, subset)
    pos = {b: t for t, b in enumerate(seq)}
    level = {}
    rows = []
    for b in seq:
        bi, bj = divmod(b, nb_j)
        preds = [qi * nb_j + qj
                 for qi in (bi - 1, bi, bi + 1) for qj in (bj - 1, bj, bj + 1)
                 if 0 <= qi < nb_i and 0 <= qj < nb_j
                 and pos.get(qi * nb_j + qj, len(seq)) < pos[b]]
        if len(preds) > MAX_PREDS:
            raise AssertionError("block %d of a %s round has %d predecessors"
                                 % (b, subset, len(preds)))
        level[b] = 1 + max((level[q] for q in preds), default=-1)
        rows.append([b] + preds + [-1] * (MAX_PREDS - len(preds)))
    table = torch.tensor(rows, dtype=torch.int32).view(-1, 1 + MAX_PREDS)
    lv = torch.tensor([level[b] for b in seq], dtype=torch.int64)
    table = table[torch.argsort(lv, stable=True)].contiguous()
    levels = torch.full((nb_i * nb_j,), -1, dtype=torch.int64)
    levels[torch.tensor(seq, dtype=torch.int64)] = lv
    return table, levels.view(nb_i, nb_j)


def round_table(nb_i, nb_j, o, subset="all"):
    """The dependency table of a K1 round at orientation ``o`` over
    ``subset`` of an ``nb_i`` × ``nb_j`` block grid: (blocks,
    1 + ``MAX_PREDS``) int32 rows of a block's flat index and its
    predecessors' (-1 past the last), in a topological order (see
    :func:`_order`).  The dataflow kernel takes its rows as tickets."""
    return _order(nb_i, nb_j, _check_orientation(o), subset)[0]


def round_levels(nb_i, nb_j, o, subset="all"):
    """The levels of a K1 round at orientation ``o`` over ``subset`` of an
    ``nb_i`` × ``nb_j`` block grid: a list of int32 tensors of flat block
    indices (``bi * nb_j + bj``), one per level, in launch order.

    A block's level is one more than the highest level of its predecessors
    (:func:`_order`), so every earlier neighbour is on a lower level and
    every later one on a higher, and the blocks of one level are no halo
    neighbours of each other: running the levels in order over one in-place
    canvas reads what the sequential grid reads, bit for bit.  On the whole
    grid, two or more blocks wide, a round is 2(nb_i - 1) + nb_j levels.
    """
    table, levels = _order(nb_i, nb_j, _check_orientation(o), subset)
    sizes = torch.bincount(levels[levels >= 0]).tolist()
    return list(torch.split(table[:, 0].contiguous(), sizes))


@functools.cache
def _device_table(nb_i, nb_j, o, subset, device):
    """:func:`round_table` on ``device``."""
    return _order(nb_i, nb_j, o, subset)[0].to(device)


def _check_form(x, K, W1, base, prev, B, ring, subset):
    """The checks of a round in the TPU's order; returns ``prev``, all ones
    when None."""
    n, m = base.shape
    _check_canvas(base, B)
    _check_subset(subset, n // B, m // B)
    if prev is None:
        prev = torch.ones((n // B, m // B), dtype=torch.int32,
                          device=x.device)
    _check_round_args(x, K, W1, base, prev, B, ring=int(ring))
    return prev


def gs_round_oriented_plain(x, K, W1, base, o, *, B, inner_max, prev=None,
                            ring=False, subset="all", inplace=False):
    """One K1 round in the TPU's Gauss-Seidel order at orientation ``o``
    (0..3), in plain PyTorch (the dataflow kernel's twin).

    The blocks of ``subset`` (``"all"``, ``"interior"`` or ``"boundary"``,
    see :func:`visit_sequence`) relax level by level (:func:`round_levels`;
    each level's blocks together, see :func:`_relax_blocks`) on the live
    canvas: those whose 3×3 block neighbourhood has a nonzero ``prev`` flag
    (the previous round's; None relaxes every block).  Equal to a loop over
    the blocks in the grid's order that reads and writes one canvas, and to
    the JAX ``gs_round_oriented`` with the same ``subset``.

    ``ring``: the ring form.  ``x``, ``K`` and ``W1`` are (n+2, m+2), the
    region that the blocks tile inside a 1-px ring (a shard's canvas, an
    engine window): the ring of ``x`` is read as the frozen halo of the rim
    blocks and never written, the ring of ``K``/``W1`` holds the ring
    pixels' real receivers.  Without it the canvas reads zeros around it.

    Returns ``(x_new, chg)``: the canvas (``x`` itself with ``inplace``,
    else a new tensor and ``x`` is not written) and the (n/B, m/B) int32
    changed flags in block coordinates, 0 for blocks outside ``subset``.
    """
    o = _check_orientation(o)
    prev = _check_form(x, K, W1, base, prev, B, ring, subset)
    n, m = base.shape
    dirty = _dirty(prev)
    levels = _order(n // B, m // B, o, subset)[1].to(x.device)
    if ring:
        xr, Wr = x, expand_compact(K, W1)
    else:
        # a ring of zeros and "no edge" weights reads as the canvas's pad
        xr = F.pad(x, (1, 1, 1, 1))
        Wr = F.pad(expand_compact(K, W1), (1, 1, 1, 1))
    chg = torch.zeros((n // B, m // B), dtype=torch.int32, device=x.device)
    for t in range(int(levels.max()) + 1):
        level = dirty & (levels == t)
        if not bool(level.any()):
            continue
        xr, chg_t = _relax_blocks(xr, Wr, base, level, B=B,
                                  inner_max=inner_max, ring=True)
        chg[level] = chg_t[level]
    out = xr if ring else xr[1:-1, 1:-1]
    if inplace:
        return x.copy_(out), chg
    return (out.clone() if out is x else out.contiguous()), chg


def block_round_plain(x, W, base, *, B, inner_max):
    """One K2 round in plain PyTorch (the kernel's twin): every block
    relaxes (see :func:`_relax_blocks`) on the dense (8, n, m) planes ``W``,
    which may hold any nonnegative weights.

    Returns ``(x_new, chg)`` with ``chg`` the (n/B, m/B) int32 changed flags.
    """
    _check_block_args(x, W, base, B)
    n, m = x.shape
    dirty = torch.ones((n // B, m // B), dtype=torch.bool, device=x.device)
    return _relax_blocks(x, W, base, dirty, B=B, inner_max=inner_max)


def _check_kernel_args(x, B, named, blocks=KERNEL_BLOCKS):
    if x.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % x.dtype)
    if B not in blocks:
        raise ValueError("the CUDA kernel is built for B in %s, got %d"
                         % (blocks, B))
    for name, t in (("x", x),) + named:
        if t.device != x.device:
            raise ValueError("%s is on %s, x on %s"
                             % (name, t.device, x.device))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def _count(wrapper, device, launches=1, B=None):
    """``launches`` launches of ``wrapper``'s kernel on ``device``, and at
    block size ``B`` where the wrapper counts by block size too
    (``launches_by_block``)."""
    wrapper.launches_on[device] += launches
    if B is not None:
        wrapper.launches_by_block[B] += launches


def launch_count(wrapper):
    """The kernel launches of ``wrapper`` on every device (its
    ``launches_on`` summed)."""
    return sum(wrapper.launches_on.values())


def _launch(entry, *args):
    """Call a C entry of ``csrc/uca_block.cu`` on the current stream of the
    first tensor's device: tensors become pointers, ints stay ints."""
    fn = _kernel(entry)
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (entry, err))


class _Tickets:
    """The device state of dataflow rounds on one stream, for one block
    grid: a 64-bit ticket counter and a "done" epoch per block, allocated
    once and never reset.  Each round takes the next epoch; a launch of
    ``c`` units (CTAs, or clusters at B = 128 and 256) over ``t`` tickets
    adds ``t + c`` to the counter (each unit draws one ticket past the
    last), so the host knows where the next round's tickets start without
    reading the device."""

    def __init__(self, blocks, device):
        self.buf = torch.zeros(2 + blocks, dtype=torch.int32, device=device)
        self.start = 0
        self.epoch = 0


@functools.cache
def _tickets(device, stream, blocks):
    """The :class:`_Tickets` of ``stream`` on ``device`` for a grid of
    ``blocks`` blocks: rounds on one stream run one after another, rounds
    on two streams (the split round's shards) never share one."""
    return _Tickets(blocks, device)


_KINDS = ("dataflow", "k2")


@functools.cache
def resident_units(device, B, ring=False, kind="dataflow"):
    """How many units of a kernel the card ``device`` holds at once: CTAs
    at B = 8 to 64, clusters of :func:`kernel_cluster_size` CTAs at 128
    and 256; ``kind`` ``"dataflow"`` (K1 in the TPU's order, ``ring`` its
    ring form) or ``"k2"``.  Raises ``RuntimeError`` when none can be
    resident: the wrappers launch the cluster kernel or raise, never run
    another block size instead."""
    from ._build import load

    fn = load("uca_block").uca_resident_units
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        units = fn(_KINDS.index(kind), B, int(ring))
    if units < 0:
        raise RuntimeError("uca_resident_units(%s, B=%d) failed: cudaError "
                           "%d" % (kind, B, -units))
    if units == 0:
        raise RuntimeError("no cluster of %d CTAs of the %s kernel at B=%d "
                           "can be resident on %s"
                           % (kernel_cluster_size(B), kind, B, device))
    return units


def gs_round_oriented(x, K, W1, base, o, *, B, inner_max, prev=None,
                      ring=False, subset="all", inplace=False):
    """One K1 round in the TPU's Gauss-Seidel order at orientation ``o``
    (0..3; the JAX function's name and arguments, with ``subset``): for
    CUDA tensors the dataflow kernel, one launch a round; for CPU tensors
    the plain version.  See :func:`gs_round_oriented_plain` for the
    contract (``ring``, ``subset``, ``inplace``; ``prev`` the previous
    round's (n/B, m/B) int32 flags, None for every block).

    The launch is persistent: each CTA draws tickets, the rows of
    :func:`round_table` in order, from a counter, waits until the block's
    predecessors have published this round's epoch, relaxes it in place and
    publishes.  ``gs_round_oriented.launches_on`` counts kernel launches
    (one a round) by device, never plain runs.
    """
    if x.device.type == "cpu":
        return gs_round_oriented_plain(x, K, W1, base, o, B=B,
                                       inner_max=inner_max, prev=prev,
                                       ring=ring, subset=subset,
                                       inplace=inplace)
    if x.device.type != "cuda":
        raise ValueError("gs_round_oriented: unsupported device %s"
                         % x.device)
    o = _check_orientation(o)
    prev = _check_form(x, K, W1, base, prev, B, ring, subset)
    _check_kernel_args(x, B, (("K", K), ("W1", W1), ("base", base),
                              ("prev", prev)))
    n, m = base.shape
    out = x if inplace else x.clone()  # the canvas the round updates
    new = torch.empty if subset == "all" else torch.zeros
    chg = new((n // B, m // B), dtype=torch.int32, device=x.device)
    table = _device_table(n // B, m // B, o, subset, x.device)
    rows = table.shape[0]
    units = min(rows, resident_units(x.device, B, bool(ring)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    st = _tickets(x.device, stream, (n // B) * (m // B))
    st.epoch += 1
    try:
        _launch("uca_gs_round_dataflow_f32", out, K, W1, base, prev, chg,
                table, st.buf, n, m, B, inner_max, int(bool(ring)), rows,
                units, st.epoch, st.start)
    except RuntimeError:
        _tickets.cache_clear()  # the counter no longer says where it is
        raise
    st.start += rows + units
    _count(gs_round_oriented, x.device, B=B)
    return out, chg


gs_round_oriented.launches_on = collections.Counter()
gs_round_oriented.launches_by_block = collections.Counter()


def block_round(x, W, base, *, B, inner_max):
    """One K2 round: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  See :func:`block_round_plain` for the contract.

    ``block_round.launches_on`` counts kernel launches by device (never
    plain runs).
    """
    if x.device.type == "cpu":
        return block_round_plain(x, W, base, B=B, inner_max=inner_max)
    if x.device.type != "cuda":
        raise ValueError("block_round: unsupported device %s" % x.device)
    _check_block_args(x, W, base, B)
    _check_kernel_args(x, B, (("W", W), ("base", base)))
    n, m = x.shape
    out = torch.empty_like(x)
    chg = torch.empty((n // B, m // B), dtype=torch.int32, device=x.device)
    _launch("uca_block_round_f32", x, W, base, out, chg, n, m, B, inner_max)
    _count(block_round, x.device, B=B)
    return out, chg


block_round.launches_on = collections.Counter()
block_round.launches_by_block = collections.Counter()

# The cluster visits the sweep probe times (``csrc/uca_block.cu`` enum
# Visit, in order): "async", the kernels' own; "sweep", the first cluster
# visit (the edge rows stored into the neighbours and a cluster barrier
# every sweep); and "sweep" with its stores cut, or with its barriers after
# sweeps 1-3 of a 4-sweep group a CTA barrier.
PROBE_VISITS = ("async", "sweep", "sweep_no_stores", "sweep_cta_barrier")


def probe_round(x, W, base, *, B, inner_max, visit):
    """One K2 round (:func:`block_round`) through the sweep probe's kernel
    with the cluster visit ``visit`` (one of :data:`PROBE_VISITS`) at
    B = 128 or 256, CUDA tensors only: for timing a sweep of each visit.
    The variants with something cut return wrong values by design.  The
    probe counts no launches and no solver calls it.  Returns
    ``(x_new, chg)``."""
    if visit not in PROBE_VISITS:
        raise ValueError("visit must be one of %s, got %r"
                         % (PROBE_VISITS, visit))
    if x.device.type != "cuda":
        raise ValueError("probe_round: unsupported device %s" % x.device)
    _check_block_args(x, W, base, B)
    _check_kernel_args(x, B, (("W", W), ("base", base)), (128, 256))
    n, m = x.shape
    out = torch.empty_like(x)
    chg = torch.empty((n // B, m // B), dtype=torch.int32, device=x.device)
    _launch("uca_probe_round_f32", x, W, base, out, chg, n, m, B, inner_max,
            PROBE_VISITS.index(visit))
    return out, chg


def launch_counts():
    """Every kernel wrapper's launches on every device, by kernel name."""
    return {"uca_gs_round_dataflow": launch_count(gs_round_oriented),
            "uca_block_round": launch_count(block_round)}

# C entries of csrc/uca_block.cu that launch, by argument: a pointer (p), an
# int (i), a 64-bit unsigned int (q); then the stream
_ENTRIES = {"uca_gs_round_dataflow_f32": "ppppppppiiiiiiiiq",
            "uca_block_round_f32": "pppppiiii",
            "uca_probe_round_f32": "pppppiiiii"}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_ulonglong}


@functools.cache
def _kernel(entry):
    from ._build import load

    fn = getattr(load("uca_block"), entry)
    fn.argtypes = [_CTYPES[c] for c in _ENTRIES[entry]] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_smem_bytes(B):
    """Dynamic shared memory, in bytes, of one CTA of either kernel at
    block size ``B`` (builds the kernels if need be)."""
    from ._build import load

    fn = load("uca_block").uca_block_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(B)


def kernel_cluster_size(B):
    """The CTAs of the thread-block cluster that relaxes one block at block
    size ``B``: 1 at 8 to 64, 4 at 128, 16 at 256 (builds the kernels if
    need be)."""
    from ._build import load

    fn = load("uca_block").uca_block_cluster_size
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(B)


def _padded_check(base, B, inner_max):
    n, m = base.shape
    if n % B or m % B:
        raise ValueError("canvas %dx%d must be padded to the block size %d"
                         % (n, m, B))
    return 2 * B + 4 if inner_max is None else inner_max


def _block_any(mask, B):
    """(n, m) bool -> (n/B, m/B) int32: any within each B×B block."""
    n, m = mask.shape
    return mask.view(n // B, B, m // B, B).any(3).any(1).to(torch.int32)


# rounds a K1 solve enqueues between two reads of their changed flags
ROUNDS_PER_READ = 4


def _gs_solve(base, W, B, inner_max, max_rounds, round_fn, links=None,
              x0=None):
    """K1 round driver, with pit links folded into the base before each
    round when ``links`` is given.

    ``W`` is the dense (8, ., .) planes or their compact ``(K, W1)`` pair.
    The solve starts from ``base``, or from ``x0`` when given.  Each round
    is ``round_fn(x, K, W1, b, prev, B=, inner_max=)``, called once a round
    in order (:func:`_in_turn` binds the TPU order's orientations to it).
    For the ring form (``round_fn`` ``_in_turn(gs_round_oriented, o0,
    ring=True)``) ``x0`` and the weights are 2 px larger than ``base`` each
    way, and so is the canvas returned; ``links`` index a canvas of
    ``base``'s shape and are not used with a ring.

    The fold, ``base + links(x)``, is evaluated from the canvas at the start
    of every round; blocks whose folded base changed are marked dirty beside
    those whose 3×3 neighbourhood changed last round.  The solve ends with
    the first round that changed no block: the canvas, and with it the fold,
    then stay as they are.

    The host reads the flags once per ``ROUNDS_PER_READ`` rounds (never
    enqueueing past ``max_rounds``): each round's count of changed blocks
    stays on the device, and one transfer brings the batch's counts.  A
    round after a round without change is a bitwise no-op (every block is
    skipped), so the canvas returned is that of the first still round and
    ``rounds`` is that round's index, exactly as if the flags were read
    after every round.  The counter ``solve_reads`` counts the transfers.
    """
    with span("solve"):
        inner_max = _padded_check(base, B, inner_max)
        n, m = base.shape
        if isinstance(W, tuple):
            K, W1 = W
        else:
            with span("compact"):
                K, W1 = compact_from_dense(W)
        base = base.contiguous()
        # the rounds in the TPU's order update this copy in place
        x, b_prev = (base if x0 is None else x0).clone(), None
        prev = torch.ones((n // B, m // B), dtype=torch.int32,
                          device=base.device)
        rounds = 0
        while True:
            counts = []
            for _ in range(max(1, min(ROUNDS_PER_READ, max_rounds - rounds))):
                if links is None:
                    b = base
                else:
                    b = links.add_to(base, x)
                    if b_prev is not None:
                        prev = prev | _block_any(b != b_prev, B)
                x, prev = round_fn(x, K, W1, b, prev, B=B,
                                   inner_max=inner_max)
                b_prev = b
                counts.append(prev.sum())
            counts = torch.stack(counts).tolist()
            count("solve_reads")
            if 0 in counts:
                return x, rounds + counts.index(0) + 1
            rounds += len(counts)
            if rounds >= max_rounds:
                return x, rounds


def _in_turn(round_fn, o0=0, **form):
    """``round_fn``, a round in the TPU's order (:func:`gs_round_oriented`
    or its plain version), as :func:`_gs_solve` calls its rounds, in place
    on the solve's canvas: the r-th call (from 0) runs at orientation
    ``(o0 + r) % 4``, as the JAX solvers run round r (``o0`` = 0) and the
    JAX engine's visit in outer round ``o0``.  ``form``: ``ring=True`` for
    the ring form.  One per solve."""
    calls = itertools.count(o0)

    def round_r(x, K, W1, b, prev, *, B, inner_max):
        return round_fn(x, K, W1, b, next(calls) % 4, B=B,
                        inner_max=inner_max, prev=prev, inplace=True, **form)

    return round_r


def accumulate_blocked_gs(base, W, B=256, inner_max=None, max_rounds=100_000,
                          round_fn=gs_round_oriented):
    """Solve area = base + A·area by K1 rounds in the TPU's Gauss-Seidel
    order, round r at orientation r % 4, as the JAX function does.

    ``base``: (n, m); ``W``: (8, n, m); n, m multiples of B (the caller pads
    the canvas with zeros, which is exact).  ``inner_max`` caps the sweeps
    per block visit (default 2B+4).  ``round_fn`` is the round to iterate:
    :func:`gs_round_oriented`, or :func:`gs_round_oriented_plain` to hold
    the kernel against its plain version on the same device.  Returns
    ``(area, rounds)``: the JAX function's rounds at the same ``B`` and
    ``inner_max`` (B defaults to the JAX function's 256).
    """
    return _gs_solve(base, W, B, inner_max, max_rounds, _in_turn(round_fn))


def accumulate_blocked_pits_gs(base, W, pit_src, pit_dst, pit_w, B=256,
                               inner_max=None, max_rounds=100_000,
                               round_fn=gs_round_oriented):
    """:func:`accumulate_blocked_gs` with non-adjacent pit links
    (``pit_src → pit_dst`` with weight ``pit_w``, flat indices into the
    canvas), folded into the base at the start of every round with the
    deterministic fold of :class:`PitLinks`."""
    return _gs_solve(base, W, B, inner_max, max_rounds, _in_turn(round_fn),
                     PitLinks(pit_src, pit_dst, pit_w))


def accumulate_blocked(base, W, B=256, inner_max=None, max_rounds=100_000,
                       round_fn=block_round):
    """Solve area = base + A·area by K2 rounds (every block every round, on
    the dense planes ``W``, which may hold any nonnegative weights).

    Same arguments as :func:`accumulate_blocked_gs`; ``round_fn`` is
    :func:`block_round` or :func:`block_round_plain`.  Returns
    ``(area, rounds)``; the rounds are those of the JAX version.
    """
    inner_max = _padded_check(base, B, inner_max)
    base, W = base.contiguous(), W.contiguous()
    x, chg = round_fn(base, W, base, B=B, inner_max=inner_max)
    rounds = 1
    while rounds < max_rounds and int(chg.sum()) > 0:
        x, chg = round_fn(x, W, base, B=B, inner_max=inner_max)
        rounds += 1
    return x, rounds


def accumulate_blocked_pits(base, W, pit_src, pit_dst, pit_w, B=256,
                            inner_max=None, max_rounds=100_000,
                            round_fn=block_round):
    """:func:`accumulate_blocked` with non-adjacent pit links folded into
    the base between rounds: solve x = base + P·x_prev + A·x, update the pit
    inflow, repeat, a nested fixed point that converges to
    x = base + (A+P)·x on the pruned (acyclic) drainage graph.

    The JAX version's rule, exactly: the first round runs on the bare base,
    every later round on ``base + links(x)`` with x the round-start canvas,
    and the loop stops after a round that left x unchanged (at least two
    rounds).  One host sync per round.
    """
    inner_max = _padded_check(base, B, inner_max)
    base, W = base.contiguous(), W.contiguous()
    links = PitLinks(pit_src, pit_dst, pit_w)
    x, _chg = round_fn(base, W, base, B=B, inner_max=inner_max)
    rounds = 1
    moved = True
    while moved and rounds < max_rounds:
        x1, _chg = round_fn(x, W, links.add_to(base, x), B=B,
                            inner_max=inner_max)
        moved = bool((x1 != x).any())
        x = x1
        rounds += 1
    return x, rounds
