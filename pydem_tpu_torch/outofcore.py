"""Bounded-memory (out-of-core) terrain pipeline over a store-resident canvas.

Port of ``pydem_tpu/outofcore.py``.  The reference processes an unbounded
directory of tiles with bounded memory by running one subprocess per tile and
pushing every intermediate through a zarr store, iterating cross-tile UCA
edge corrections until a fixed point.  This module is the same capability
around the blocked relaxation kernel, one level up the memory hierarchy:

====================  =========================  =========================
level                 reference                  pydem_tpu_torch
====================  =========================  =========================
unit of residence     tile file / subprocess     S×S super-block on the GPU
fast memory           worker RAM                 shared memory (B×B blocks)
slow memory           zarr directory             ArrayStore (zarr-v2 layout)
halo transport        zarr edge strips           1-px store window ring
convergence           done/todo masks per tile   per-block changed flags
====================  =========================  =========================

Peak memory is O(S²) on host and device regardless of domain size: every
stage streams super-block windows through :class:`pydem_tpu_torch.io.store
.ArrayStore`'s chunk-granular IO.  Within a super-block visit the solver is
the K1 kernel in its ring form (``ops.uca_block.gs_round_oriented(...,
ring=True)``, the TPU's Gauss-Seidel order) iterated to local convergence
against a frozen 1-px ring read from the store, and the
outer loop sweeps super-blocks in corner-cycling (fast-sweeping) order until
no block changes: chaotic relaxation, so the fixed point equals the
single-canvas result.  When the whole canvas fits the device budget the
stages after conditioning run as one device-resident pass instead.

Per-super-block conditioning/pit-connectivity is host code on a
``margin``-px context window; like the reference's per-tile conditioning,
features larger than the margin that straddle block seams may condition
differently than a global pass (the margin, 64 px by default, exceeds the
reference's per-tile context of 0).

Differences from the JAX module, by design:

- ``device`` (default ``"cuda"``; raises without a GPU, the CPU only when
  asked for).  Floats are :func:`pydem_tpu_torch.default_dtype` of it.
- The visit is the JAX one: its rounds run in the TPU's order, round r at
  orientation ``(o0 + r) % 4`` with ``o0`` the engine's outer round, so at
  the same K1 block size B a visit returns the JAX visit's rounds and
  values.  The JAX engine takes B = 8 on the CPU and 256 on a TPU (128
  for super-blocks under 256); the port takes the TPU's rule on a GPU
  (:func:`_engine_block_size`: a visit at 128 or 256 runs on a
  thread-block cluster), so there its outer rounds are those of the JAX
  engine on a TPU, and it raises, as the JAX engine does, for a
  super-block that B does not divide; on the CPU it takes 64, or 16.
- No padding buckets and no jitted closures: eager PyTorch compiles nothing,
  so pit links keep their exact size and ``links=None`` means no links.
- ``mesh`` (a :class:`~pydem_tpu_torch.parallel.mesh.Mesh` whose shards are
  all in this process): the device-resident stages hold the canvas as the
  mesh's shards, each on its cell's device (one card, or one card a shard),
  padded to a multiple of the mesh with NaN elevation (the canvas edge's
  pruning) and zero base.  Store windows stream into and out of the shards
  they cover; section, proportion and the receiver weights are computed per
  shard with the elevation halo from the mesh's exchange; the solve is the
  sharded K1 solver (``parallel.sharded._blocked_shards``) on those shards,
  or, where they are not whole K1 blocks, on shards of a canvas padded
  further to whole blocks (the compact weights re-cut between the cards'
  pieces), with no whole canvas on any device.  So the budget is per
  device, as in the JAX engine ("state per chip = canvas / n_devices"): the
  planes of the shards a device holds against its budget
  (:func:`fits_device_resident`); four cards hold four times the canvas,
  four shards on one card what one card holds.  The fused pass runs only
  when the mesh divides the canvas: its slope program would see a padded
  canvas's edge elsewhere.
"""
from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import default_dtype
from .api import DEMProcessor, _slope_program, _solve_uca
from .core import conditioning as cond
from .core.receivers import receiver_weights, section_proportion
from .core.twi import twi as twi_fn
from .ops.uca_block import (_gs_solve, _in_turn, compact_from_dense,
                            gs_round_oriented)
from .parallel.mesh import check_mesh, shard_dims
from .parallel.mesh import cut as _cut
from .parallel.mesh import pieces as _mesh_pieces

# super-block visit corner orders per outer round
_SWEEP_FLIPS = ((False, False), (True, True), (False, True), (True, False))

# Peak device memory of the fused device-resident pass, in planes of the
# canvas at the work dtype: see _fits_device_resident.
_DEVICE_RESIDENT_PLANES = 36


def _default_device_cache(device="cuda"):
    """Budget for device-resident state: 60% of the card's total memory
    (headroom for the solver's transients), a 4 GiB constant on the CPU.
    The ``PYDEM_OOC_DEVICE_CACHE`` env var overrides both."""
    env = os.environ.get("PYDEM_OOC_DEVICE_CACHE")
    if env is not None:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * 0.6)
    return 4 << 30


def fits_device_resident(shape, itemsize, budget, mesh=None):
    """Whether the fused device-resident pass fits: its peak,
    ``_DEVICE_RESIDENT_PLANES`` planes of what a device holds, against
    ``budget`` bytes a device.  ``shape``: the canvas as the devices hold it
    (padded); without a mesh one device holds it all, with one each device
    holds the shards of this process that name it.  The CPU's devices are
    one memory, so a mesh of CPU cells holds what the CPU holds."""
    n, m = shape
    held = n * m
    if mesh is not None:
        n_l, m_l = shard_dims(shape, mesh)
        per = {}
        for cell in mesh.local_shards():
            dev = mesh.devices[cell]
            key = dev if dev.type == "cuda" else dev.type
            per[key] = per.get(key, 0) + 1
        held = max(per.values()) * n_l * m_l
    return _DEVICE_RESIDENT_PLANES * held * itemsize <= budget


def _sb_weights(elev_win, dir_win, flats_win, theta_win):
    """Compact receivers ``(K, W1)`` of an (S+2)² window, recomputed from the
    stored direction/flats/elev windows.  That reproduces the global
    ``receiver_weights`` for every edge between two pixels of the window
    (off-window shifts fill with NaN, the pruning the canvas edge sees); the
    ring pixels' weights are real, since they send flow into the interior."""
    section, proportion = section_proportion(dir_win, flats_win,
                                             theta=theta_win)
    return compact_from_dense(receiver_weights(section, proportion, elev_win))


def _sb_relax(x_win, K, W1, base_eff, o0, B, inner_max, max_rounds):
    """K1 ring rounds in the TPU's order on one window until no block
    changes (at most ``max_rounds``): round r at orientation ``(o0 + r) %
    4``, the first over every block, later ones with the frontier flags
    threaded, as the JAX visit runs them.  Returns the relaxed S×S
    interior, whether it changed (a 0-dim bool tensor), and the round
    count."""
    xp, rounds = _gs_solve(base_eff, (K, W1), B, inner_max, max_rounds,
                           _in_turn(gs_round_oriented, o0, ring=True),
                           x0=x_win)
    out = xp[1:-1, 1:-1]
    return out, (out != x_win[1:-1, 1:-1]).any(), rounds


def _sb_uca_solve(x_win, elev_win, dir_win, flats_win, theta_win, base_eff,
                  o0, B, inner_max, max_rounds):
    """Relax one (S+2)²-windowed super-block to convergence on the device.

    ``x_win`` carries the current area state with its frozen 1-px ring
    (NaN-filled beyond the canvas: sanitised here, since ring NaNs would
    poison the 0-weight products).  The ring is read as x, never folded into
    the base, so every pixel's sum rounds as in a whole-canvas solve.
    ``o0``: the engine's outer round, the orientation of the visit's first
    round (see :func:`_sb_relax`).  Returns the relaxed S×S interior,
    whether it changed, and the round count.
    """
    K, W1 = _sb_weights(elev_win, dir_win, flats_win, theta_win)
    return _sb_relax(torch.nan_to_num(x_win), K, W1, base_eff, o0, B,
                     inner_max, max_rounds)


def _engine_block_size(S, device):
    """The K1 block size within an S² super-block window on ``device``: the
    JAX engine's rule on a TPU, ``256 if S >= 256 else 128``, on a GPU; on
    the CPU 64, or 16 where 64 does not divide S (the JAX engine takes
    interpret mode's B = 8 there, and the tests set ``eng.B`` to compare).
    Raises ``ValueError`` for a super-block that B does not divide, as the
    JAX engine does."""
    if torch.device(device).type == "cpu":
        B = 64 if S >= 64 and S % 64 == 0 else 16
    else:
        B = 256 if S >= 256 else 128
    if S % B:
        raise ValueError("superblock (%d) must be a multiple of the kernel "
                         "block size (%d)" % (S, B))
    return B


class OutOfCoreEngine:
    """Stream the full pipeline through the store in S×S super-blocks."""

    def __init__(self, store, shape, dX, dY, dX2, dY2, dem_proc_kwargs=None,
                 superblock=512, margin=None, resume=False, timer=None,
                 mesh=None, device_cache_bytes=None, device="cuda"):
        self.store = store
        self.shape = tuple(shape)
        self.dX = np.asarray(dX, "float64")
        self.dY = np.asarray(dY, "float64")
        self.dX2 = np.asarray(dX2, "float64")
        self.dY2 = np.asarray(dY2, "float64")
        # flag carrier: reuse DEMProcessor's validated config surface (and
        # its device check: "cuda" without a GPU raises)
        self.dp = DEMProcessor(elev=np.zeros((2, 2)), device=device,
                               **(dem_proc_kwargs or {}))
        self.device = self.dp.device
        check_mesh(mesh, self.device)
        if mesh is not None and mesh.distributed:
            raise ValueError("the out-of-core engine's mesh must hold every "
                             "shard in this process: ranks of a distributed "
                             "mesh would each write the shared store")
        self.mesh = mesh
        if self.dp.drain_flats or self.dp.drain_pits_spill:
            raise NotImplementedError(
                "deprecated drain modes are not supported out-of-core")
        self.S = int(superblock)
        self.margin = int(margin if margin is not None
                          else max(64, 2 * self.dp.drain_pits_max_dist))
        self.resume = resume
        # a device's budget: with a mesh the smallest of its devices'
        if device_cache_bytes is None:
            device_cache_bytes = min(_default_device_cache(d) for d in (
                [self.device] if mesh is None
                else [d for d, _ks in mesh.devices_of()]))
        self.device_cache_bytes = int(device_cache_bytes)
        n, m = self.shape
        self.nbi = -(-n // self.S)
        self.nbj = -(-m // self.S)
        # K1 block size within a super-block window: the JAX engine's rule
        # on a GPU; on the CPU (where the JAX engine takes interpret mode's
        # B = 8) 64, or 16 for super-blocks that 64 does not divide
        self.B = _engine_block_size(self.S, self.device)
        t = np.arctan2(self.dY[: n - 2], self.dX[: n - 2])
        self.theta = t[np.clip(np.arange(n) - 1, 0, n - 3)]
        self.min_area = float(np.nanmin(self.dX2 * self.dY2))
        self.timer = timer
        self._links = None
        self._drained = None
        # super-block visits made and skipped by the frontier in uca()
        self.uca_visits = self.uca_skipped = 0

    # -- helpers -------------------------------------------------------------

    def _blocks(self, flip=(False, False)):
        bi = range(self.nbi - 1, -1, -1) if flip[0] else range(self.nbi)
        bj_fwd = list(range(self.nbj))
        bj_rev = bj_fwd[::-1]
        for i in bi:
            for j in (bj_rev if flip[1] else bj_fwd):
                yield i, j

    def _interior(self, bi, bj):
        n, m = self.shape
        i0, j0 = bi * self.S, bj * self.S
        return (i0, min(i0 + self.S, n)), (j0, min(j0 + self.S, m))

    @property
    def _work_dtype(self):
        """Storage dtype for device-produced intermediates: the device's
        float dtype (float32 on the card, float64 on the CPU); storing
        float64 for float32 numerics would double the IO volume."""
        return str(default_dtype(self.device)).replace("torch.", "")

    def _to_dev(self, a, device=None):
        """A host array on the engine's device (or ``device``): floats in
        the work dtype, bool and integer planes as they are."""
        a = np.ascontiguousarray(a)
        return torch.as_tensor(
            a, dtype=default_dtype(self.device) if a.dtype.kind == "f"
            else None, device=self.device if device is None else device)

    def _create(self, name, dtype="float64", fill=np.nan):
        # sub-chunking below the super-block: a ±1-ring window read then
        # touches ~((S/c)+1)² chunks of c² bytes (~1.2x amplification)
        # instead of 4 full S² chunks (4x); compression is off: float
        # terrain chunks barely compress, and zlib would be on every
        # window's path
        c = min(self.S, 1024)
        self.store.create(name, self.shape, dtype, chunks=(c, c), fill=fill,
                          compress=False)

    def _flags(self, stage):
        key = "_oocore_%s" % stage
        fn = os.path.join(self.store.root, key + ".json")
        if self.resume and os.path.exists(fn):
            with open(fn) as f:
                return set(map(tuple, json.load(f)))
        return set()

    def _mark(self, stage, done):
        fn = os.path.join(self.store.root, "_oocore_%s.json" % stage)
        with open(fn, "w") as f:
            json.dump(sorted(done), f)

    def _stage(self, name):
        if self.timer is not None:
            return self.timer.stage(name)
        return contextlib.nullcontext()

    # -- stage 1: conditioning (per-window host, reference semantics) --------

    def condition(self, src="elev_src", dst="elev"):
        dp = self.dp
        self._create(dst)
        done = self._flags("condition")
        # no conditioning ops -> plain re-chunking copy, no margin context
        M = self.margin if (dp.fill_flats or dp.drain_pits_path) else 0
        n, m = self.shape
        for bi, bj in self._blocks():
            if (bi, bj) in done:
                continue
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            r0, r1 = max(0, i0 - M), min(n, i1 + M)
            c0, c1 = max(0, j0 - M), min(m, j1 + M)
            e = self.store.read_window(src, (r0, r1), (c0, c1))
            if dp.fill_flats:
                e = cond.fill_flats(
                    e, source_tol=dp.fill_flats_source_tol,
                    fill_peaks=dp.fill_flats_peaks,
                    fill_pits=dp.fill_flats_pits,
                    below_sea=dp.fill_flats_below_sea,
                    maximum_pit_area=dp.maximum_pit_area)
            if dp.drain_pits_path:
                e = cond.drain_pit_paths(
                    e, self.dX[r0: r1 - 1], self.dY[r0: r1 - 1],
                    max_iter=dp.drain_pits_max_iter,
                    max_dist=dp.drain_pits_max_dist,
                    max_dist_XY=dp.drain_pits_max_dist_XY,
                    below_sea=dp.fill_flats_below_sea)
            self.store.write_window(dst, e[i0 - r0: i1 - r0,
                                           j0 - c0: j1 - c0], (i0, j0))
            done.add((bi, bj))
            self._mark("condition", done)

    # -- stage 2: slope/direction/flats (device stencil per window) ----------

    def slope_direction(self, src="elev"):
        O = 4  # stencil context: mag radius 1 + flat extension radius 1 + pad
        for name in ("slope", "aspect"):
            self._create(name, self._work_dtype)
        self._create("flats", "bool", fill=False)
        done = self._flags("slope")
        n, m = self.shape
        for bi, bj in self._blocks():
            if (bi, bj) in done:
                continue
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            # clipped windows: at canvas borders the window edge IS the
            # canvas edge, so the stencil's edge facet subsets apply exactly
            r0, r1 = max(0, i0 - O), min(n, i1 + O)
            c0, c1 = max(0, j0 - O), min(m, j1 + O)
            e = self.store.read_window(src, (r0, r1), (c0, c1))
            mag, direction, flats = _slope_program(
                self._to_dev(e), self._to_dev(self.dX[r0: r1 - 1]),
                self._to_dev(self.dY[r0: r1 - 1]))
            sl = (slice(i0 - r0, i1 - r0), slice(j0 - c0, j1 - c0))
            for name, plane in (("slope", mag), ("aspect", direction),
                                ("flats", flats)):
                self.store.write_window(name, plane[sl].cpu().numpy(),
                                        (i0, j0))
            done.add((bi, bj))
            self._mark("slope", done)

    # -- stage 3: pit connectivity (host per-window, global link list) -------

    def pit_links(self):
        """Non-adjacent pit drain links per margin window; updates
        'flats'/'slope' in place and persists the global link list."""
        fn = os.path.join(self.store.root, "pit_links.npz")
        if self.resume and os.path.exists(fn) and self._links is None:
            with np.load(fn) as z:
                self._links = (z["src"], z["dst"], z["w"])
                if "drained_idx" in z:
                    self._drained = (z["drained_idx"], z["drained_mag"])
            return self._links
        self._drained = (np.zeros(0, "int64"), np.zeros(0, "float64"))
        if not self.dp.drain_pits:
            self._links = (np.zeros(0, "int64"), np.zeros(0, "int64"),
                           np.zeros(0, "float64"))
            np.savez(fn, src=self._links[0], dst=self._links[1],
                     w=self._links[2], drained_idx=self._drained[0],
                     drained_mag=self._drained[1])
            return self._links
        M = self.margin
        n, m = self.shape
        src_all, dst_all, w_all = [], [], []
        drained_idx, drained_mag = [], []
        for bi, bj in self._blocks():
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            r0, r1 = max(0, i0 - M), min(n, i1 + M)
            c0, c1 = max(0, j0 - M), min(m, j1 + M)
            flats = self.store.read_window("flats", (r0, r1), (c0, c1))
            elev = self.store.read_window("elev", (r0, r1), (c0, c1))
            mag = self.store.read_window("slope", (r0, r1), (c0, c1))
            src, dst, w, flats2, mag2 = cond.connectivity_pits(
                flats, elev, mag, self.dX[r0: r1 - 1], self.dY[r0: r1 - 1],
                max_iter=self.dp.drain_pits_max_iter,
                max_dist=self.dp.drain_pits_max_dist,
                max_dist_XY=self.dp.drain_pits_max_dist_XY,
                min_border=self.dp.drain_pits_min_border)
            mw = c1 - c0
            si, sj = src // mw, src % mw
            # a link is owned by the block whose interior holds its source
            keep = ((w > 1e-8) & (si >= i0 - r0) & (si < i1 - r0)
                    & (sj >= j0 - c0) & (sj < j1 - c0))
            di, dj = dst // mw, dst % mw
            src_all.append((si[keep] + r0) * m + sj[keep] + c0)
            dst_all.append((di[keep] + r0) * m + dj[keep] + c0)
            w_all.append(w[keep])
            sl = (slice(i0 - r0, i1 - r0), slice(j0 - c0, j1 - c0))
            # drained-pit diff (flats cleared, mag set): lets the fused
            # device-resident pipeline apply the updates as a tiny scatter
            # instead of re-uploading the whole flats/slope canvases
            dmask = flats[sl] & ~flats2[sl]
            ddi, ddj = np.nonzero(dmask)
            drained_idx.append((ddi + i0) * m + ddj + j0)
            drained_mag.append(mag2[sl][dmask])
            self.store.write_window("flats", flats2[sl], (i0, j0))
            self.store.write_window("slope", mag2[sl], (i0, j0))
        self._links = (np.concatenate(src_all).astype("int64"),
                       np.concatenate(dst_all).astype("int64"),
                       np.concatenate(w_all))
        self._drained = (np.concatenate(drained_idx).astype("int64"),
                         np.concatenate(drained_mag).astype("float64"))
        np.savez(fn, src=self._links[0], dst=self._links[1],
                 w=self._links[2], drained_idx=self._drained[0],
                 drained_mag=self._drained[1])
        return self._links

    # -- stage 4: UCA super-block rounds --------------------------------------

    def _gather_state(self, idx):
        """Current 'uca_state' values at flat indices, chunk-grouped reads."""
        n, m = self.shape
        si, sj = idx // m, idx % m
        out = np.zeros(idx.shape, "float64")
        keys = (si // self.S) * self.nbj + (sj // self.S)
        for key in np.unique(keys):
            bi, bj = int(key) // self.nbj, int(key) % self.nbj
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            blk = self.store.read_window("uca_state", (i0, i1), (j0, j1))
            sel = keys == key
            out[sel] = blk[si[sel] - i0, sj[sel] - j0]
        return out

    def _base_block(self, bi, bj):
        (i0, i1), (j0, j1) = self._interior(bi, bj)
        base = np.zeros((self.S, self.S), "float64")
        rows = (self.dX2 * self.dY2)[i0: i1]
        base[: i1 - i0, : j1 - j0] = np.nan_to_num(rows)[:, None]
        return base

    def _window(self, name, bi, bj):
        i0, j0 = bi * self.S, bj * self.S
        return self.store.read_window(name, (i0 - 1, i0 + self.S + 1),
                                      (j0 - 1, j0 + self.S + 1))

    def _fits_device_resident(self):
        """Whether the fused device-resident pass fits the device budget:
        the host stays O(S²), the devices hold the canvases, and the UCA
        stage collapses into one global blocked solve with no per-round
        host IO.

        The pass is eager PyTorch, which allocates a plane per
        intermediate; its peak is the slope program's.  Measured with
        ``torch.cuda.max_memory_allocated`` by ``chip_smoke.py`` (phase 10b
        and its memory probe; the numbers are in PERF.md), it stays under
        ``_DEVICE_RESIDENT_PLANES`` planes of the canvas at the work dtype.
        With a mesh each device holds its shards of the padded canvas and
        is held to its own budget (:func:`fits_device_resident`).
        """
        np_, mp_, mesh = self._padded_dims()
        return fits_device_resident(
            (np_, mp_), np.dtype(self._work_dtype).itemsize,
            self.device_cache_bytes, mesh)

    def _padded_dims(self, solve=False):
        """(np_, mp_, mesh): the canvas dims as the devices hold it, a
        multiple of the mesh's when there is one.  ``solve``: the dims of
        the sharded solve's canvas, a multiple of the mesh's shape times
        the K1 block size, so that every shard is a whole number of blocks
        (the ring rounds need it; ``sharded._solve_shards`` re-cuts the
        shards onto it).  Both pads are exact: NaN elevation, zero base,
        no weight."""
        n, m = self.shape
        if self.mesh is None:
            return n, m, None
        gy, gx = self.mesh.shape
        qy, qx = (gy * self.B, gx * self.B) if solve else (gy, gx)
        return n + (-n) % qy, m + (-m) % qx, self.mesh

    def _pieces(self):
        """Where the devices hold the padded canvas (:meth:`_padded_dims`):
        ``[(device, (row0, col0, h, w)), ...]``, the whole canvas on the
        engine's device, or the mesh's shards in :meth:`Mesh.local_shards`
        order, each on its cell's device."""
        np_, mp_, mesh = self._padded_dims()
        if mesh is None:
            return [(self.device, (0, 0, np_, mp_))]
        return _mesh_pieces(mesh, (np_, mp_))

    def _gather_canvas(self, name, dtype, fill=0):
        """Stream store windows up into the device pieces of the canvas
        (:meth:`_pieces`; returns one tensor a piece): the host never holds
        more than two S² windows (the next window is read from the store on
        a thread while the current one is copied into the pieces it covers;
        the copy from pageable memory returns when the host buffer is free
        again)."""
        pieces = self._pieces()
        out = [torch.full(piece[2:], fill, dtype=dtype, device=dev)
               for dev, piece in pieces]
        blocks = list(self._blocks())
        np_dtype = np.dtype(str(dtype).replace("torch.", ""))

        def read(b):
            (i0, i1), (j0, j1) = self._interior(*b)
            return np.ascontiguousarray(
                self.store.read_window(name, (i0, i1), (j0, j1)), np_dtype)

        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(read, blocks[0])
            for k, b in enumerate(blocks):
                w = nxt.result()
                if k + 1 < len(blocks):
                    nxt = ex.submit(read, blocks[k + 1])
                for c, (_dev, piece) in zip(out, pieces):
                    cut = _cut(self._interior(*b), piece)
                    if cut is not None:
                        c[cut[1]].copy_(torch.from_numpy(w[cut[0]]))
        return out

    def _scatter_canvas(self, name, pieces, dtype=None, fill=np.nan):
        """Stream the device pieces of a canvas (:meth:`_pieces`) down into
        store windows, each window's parts from the devices that hold them
        (the previous window's store write runs on a thread while the next
        downloads)."""
        self._create(name, dtype or self._work_dtype, fill=fill)
        where = [piece for _dev, piece in self._pieces()]
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = None
            for bi, bj in self._blocks():
                block = self._interior(bi, bj)
                (i0, i1), (j0, j1) = block
                w = None
                for t, piece in zip(pieces, where):
                    cut = _cut(block, piece)
                    if cut is None:
                        continue
                    part = t[cut[1]].cpu().numpy()
                    if part.shape == (i1 - i0, j1 - j0):
                        w = part
                        break
                    if w is None:
                        w = np.empty((i1 - i0, j1 - j0), part.dtype)
                    w[cut[0]] = part
                if pending is not None:
                    pending.result()
                pending = ex.submit(self.store.write_window, name, w,
                                    (i0, j0))
            if pending is not None:
                pending.result()

    def _uca_device_resident(self, state_fn, elev=None, direction=None,
                             flats=None):
        """Device-resident UCA: stream the static canvases to the devices
        once (or take them already there from the fused pipeline), run the
        global blocked solve (the solver of the in-core pipeline,
        ``api._solve_uca``, or with a mesh the sharded K1 solver on the
        shards), stream the state back.  ``direction``, ``flats``: the
        pieces of :meth:`_pieces`; ``elev`` too, or with a mesh the shards'
        elevation windows (``parallel.sharded._elev_windows``).  Exact: the
        streaming path's per-window weights reproduce the global
        receiver_weights (see ``_sb_weights``), and here they ARE the global
        weights.  Pit links fold in the work dtype here and in float64 on
        the host when streaming, so with links the two regimes agree to
        rounding only.  Returns ``(rounds, state pieces)``."""
        from .parallel.sharded import (_elev_windows, _solve_shards,
                                       _weights_shards)

        n, m = self.shape
        np_, mp_, mesh = self._padded_dims()
        wd = default_dtype(self.device)
        # NaN elevation beyond the logical canvas: the out-of-grid pruning
        # of receiver_weights, so the mesh's pad does not blur the edge
        if elev is None:
            elev = self._gather_canvas("elev", wd, fill=np.nan)
            if mesh is not None:
                elev = _elev_windows(elev, mesh)
        if direction is None:
            direction = self._gather_canvas("aspect", wd)
        if flats is None:
            flats = self._gather_canvas("flats", torch.bool, fill=False)
        base_rows = np.pad(np.nan_to_num(self.dX2 * self.dY2), (0, np_ - n))
        theta = np.pad(self.theta, (0, np_ - n), mode="edge")

        src, dst, w = self._links if self._links is not None \
            else self.pit_links()

        if mesh is not None:
            pieces = self._pieces()
            theta_s = [self._to_dev(theta[r0: r0 + h], dev)
                       for dev, (r0, _c0, h, _w) in pieces]
            KW = [compact_from_dense(W) for W in _weights_shards(
                direction, flats, elev, theta_s)]
            base_s = [self._to_dev(base_rows[r0: r0 + h], dev)[:, None]
                      .expand(h, w_) for dev, (r0, _c0, h, w_) in pieces]
            # the sharded solve re-cuts shards that are not whole K1
            # blocks onto the canvas padded to whole blocks, and back
            x, rounds = _solve_shards(
                base_s, KW, mesh, ((src // m) * mp_ + src % m,
                                   (dst // m) * mp_ + dst % m, w), B=self.B)
            del KW
        else:
            base = self._to_dev(base_rows)[:, None].expand(np_, mp_)
            section, proportion = section_proportion(
                direction[0], flats[0], theta=self._to_dev(theta))
            W = receiver_weights(section, proportion, elev[0])
            del section, proportion
            links = (None, None, None)
            if len(src):  # the canvas is not padded without a mesh
                links = (self._to_dev(src), self._to_dev(dst),
                         self._to_dev(w))
            x, rounds = _solve_uca(base, W, (n, m), *links, 0, 0, "blocked",
                                   self.B)
            x = [x]
            del W

        self._scatter_canvas("uca_state", x, fill=0.0)
        rounds = int(rounds)
        with open(state_fn, "w") as f:
            json.dump({"round": rounds, "mode": "device"}, f)
        self.uca_rounds = rounds
        return rounds, x

    def uca(self, max_rounds=10_000):
        """Iterate super-block rounds to the global fixed point.

        Two regimes: when the whole canvas fits the device budget the UCA
        stage runs as ONE global blocked solve with zero per-round host IO
        (:meth:`_uca_device_resident`); otherwise super-blocks stream
        through the store in corner-order rounds with a converged-block
        frontier: quiescent blocks whose ring and pit inflow did not change
        since their last visit are skipped.

        The streaming pipeline is one deep.  All store IO of a round runs on
        ONE worker thread, in the order it is submitted: while the device
        relaxes block k (the main thread blocks in the visit, which reads
        the kernel's flags every few rounds), the worker writes block k-1
        back and then reads block k+1's windows.  Block k+1 therefore sees
        block k's ring one visit stale, always and not by chance: the order
        of reads and writes does not depend on timing, so two runs give the
        same states round by round.  A stale ring is harmless for the fixed
        point (chaotic relaxation) and sound for termination: the final
        round performs no writes at all, so nothing was stale when every
        block reported unchanged.  Uploads are plain copies from pageable
        memory, done by the main thread.
        """
        state_fn = os.path.join(self.store.root, "_oocore_uca.json")
        start_round = 0
        if self.resume and "uca_state" in self.store \
                and os.path.exists(state_fn):
            with open(state_fn) as f:
                st = json.load(f)
            if st.get("mode") == "device":
                self.uca_rounds = st["round"]
                return self.uca_rounds
            start_round = st["round"]
        elif self._fits_device_resident():
            rounds, _x = self._uca_device_resident(state_fn)
            return rounds
        else:
            # init state = base area
            self._create("uca_state", self._work_dtype, fill=0.0)
            for bi, bj in self._blocks():
                (i0, i1), (j0, j1) = self._interior(bi, bj)
                self.store.write_window(
                    "uca_state", self._base_block(bi, bj)[: i1 - i0,
                                                          : j1 - j0],
                    (i0, j0))

        src, dst, w = self._links if self._links is not None \
            else self.pit_links()
        has_pits = len(src) > 0
        n, m = self.shape
        S = self.S
        # theta indexed at window rows i0-1 .. i0+S (edge-clamped, and
        # extended past the last partial block)
        theta_rows = np.pad(self.theta, (1, self.nbi * S - n + 1),
                            mode="edge")

        # Device-side cache of the per-block static planes (the compact
        # receivers K and W1 of the window, and the base): only the state
        # ring changes between rounds, so re-shipping the elev, aspect and
        # flats windows and rebuilding the weights every visit is pure
        # waste.  Bounded: enabled only when the whole set fits the budget,
        # so the engine stays O(S²)-host / O(budget)-device.
        dev_cache = {}
        isz = np.dtype(self._work_dtype).itemsize
        est = self.nbi * self.nbj * ((isz + 1) * (S + 2) ** 2 + isz * S * S)
        use_cache = est <= self.device_cache_bytes

        def read_block(bi, bj, contrib):
            """All host inputs one super-block visit needs (worker thread:
            store IO and numpy only)."""
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            x_win = self.store.read_window(
                "uca_state", (i0 - 1, i0 + S + 1), (j0 - 1, j0 + S + 1))
            static = None
            if (bi, bj) not in dev_cache:
                static = (self._window("elev", bi, bj),
                          self._window("aspect", bi, bj),
                          self._window("flats", bi, bj),
                          theta_rows[i0: i0 + S + 2])
            base_eff = None
            if has_pits:
                base_eff = self._base_block(bi, bj)
                di, dj = dst // m, dst % m
                sel = ((di >= i0) & (di < i1) & (dj >= j0) & (dj < j1))
                if sel.any():
                    np.add.at(base_eff, (di[sel] - i0, dj[sel] - j0),
                              contrib[sel])
            elif static is not None:
                base_eff = self._base_block(bi, bj)
            return bi, bj, x_win, static, base_eff

        def dispatch(blk, rounds):
            """Upload and relax one super-block in outer round ``rounds``
            (main thread)."""
            bi, bj, x_win, static, base_eff = blk
            if static is None:
                K, W1, base_d = dev_cache[(bi, bj)]
            else:
                K, W1 = _sb_weights(*(self._to_dev(a) for a in static))
                base_d = None if has_pits else self._to_dev(base_eff)
                if use_cache:
                    dev_cache[(bi, bj)] = (K, W1, base_d)
            if has_pits:
                base_d = self._to_dev(base_eff)
            out, chg, _r = _sb_relax(
                torch.nan_to_num(self._to_dev(x_win)), K, W1, base_d, rounds,
                B=self.B, inner_max=2 * self.B + 4,
                max_rounds=4 * (S // self.B) + 8)
            if not bool(chg):
                return None
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            return out[: i1 - i0, : j1 - j0].cpu().numpy(), (i0, j0)

        rounds = start_round
        prev_changed = None   # None -> visit everything (fresh/resumed)
        prev_contrib = None
        while rounds < max_rounds:
            contrib = None
            if has_pits:
                # fold pit contributions once per round (fold-before-relax,
                # the nesting of accumulate_blocked_pits_gs), in float64 on
                # the host
                contrib = self._gather_state(src) * w
            # converged-block frontier: a block's relax is a no-op unless
            # its own state, a neighbor's ring, or its pit inflow changed
            # since its last visit; skip the rest
            if prev_changed is None:
                todo = None
            else:
                todo = set()
                for (pi, pj) in prev_changed:
                    for di in (-1, 0, 1):
                        for dj in (-1, 0, 1):
                            qi, qj = pi + di, pj + dj
                            if 0 <= qi < self.nbi and 0 <= qj < self.nbj:
                                todo.add((qi, qj))
                if has_pits and prev_contrib is not None:
                    moved = contrib != prev_contrib
                    if moved.any():
                        keys = ((dst[moved] // m // S) * self.nbj
                                + (dst[moved] % m // S))
                        for key in np.unique(keys):
                            todo.add((int(key) // self.nbj,
                                      int(key) % self.nbj))
            if has_pits:
                prev_contrib = contrib
            order = [b for b in self._blocks(_SWEEP_FLIPS[rounds % 4])
                     if todo is None or b in todo]
            self.uca_visits += len(order)
            self.uca_skipped += self.nbi * self.nbj - len(order)
            round_changed = set()
            writes = []
            with ThreadPoolExecutor(max_workers=1) as io:
                nxt = io.submit(read_block, *order[0], contrib) \
                    if order else None
                for k, (bi, bj) in enumerate(order):
                    blk = nxt.result()
                    if k + 1 < len(order):
                        nxt = io.submit(read_block, *order[k + 1], contrib)
                    done = dispatch(blk, rounds)
                    if done is not None:
                        round_changed.add((bi, bj))
                        writes.append(io.submit(self.store.write_window,
                                                "uca_state", *done))
                for f in writes:  # waits for the last writes; raises theirs
                    f.result()
            prev_changed = round_changed
            rounds += 1
            with open(state_fn, "w") as f:
                json.dump({"round": rounds}, f)
            if not round_changed:
                break
        self.uca_rounds = rounds
        return rounds

    # -- stage 5: finalize (uca NaN-at-flats + TWI) ---------------------------

    def _finalize_program(self, x, flats, mag):
        """uca (NaN at flats) and TWI from the relaxed state, on the
        device; both regimes end here."""
        dp = self.dp
        uca = torch.where(flats, float("nan"), x)
        t = twi_fn(uca, mag.to(x.dtype), self.min_area,
                   min_slope=dp.twi_min_slope,
                   saturation_limit=dp.uca_saturation_limit,
                   cap_uca=dp.apply_twi_limits_on_uca,
                   cap_twi=dp.apply_twi_limits)
        return uca, t

    def finalize(self):
        # outputs stored at the working precision: float32 results in
        # float64 arrays would double the store
        self._create("uca", self._work_dtype)
        self._create("twi", self._work_dtype)
        for bi, bj in self._blocks():
            (i0, i1), (j0, j1) = self._interior(bi, bj)
            x, flats, mag = (
                self._to_dev(self.store.read_window(name, (i0, i1), (j0, j1)))
                for name in ("uca_state", "flats", "slope"))
            uca, t = self._finalize_program(x, flats, mag)
            self.store.write_window("uca", uca.cpu().numpy(), (i0, j0))
            self.store.write_window("twi", t.cpu().numpy(), (i0, j0))

    def halo_fraction(self):
        """Fraction of per-visit window traffic that is the frozen 1-px
        ring (the halo-exchange metric at super-block granularity)."""
        S = self.S
        return (((S + 2) ** 2 - S * S) / float(S * S))

    def _drain_pieces(self, mag, flats, idx, vals):
        """The pit-link stage's flats/mag mutations (flat indices ``idx``
        into the canvas, ``vals`` the new mag) applied to the device
        pieces, as a tiny scatter on each."""
        m = self.shape[1]
        i, j = idx // m, idx % m
        out_mag, out_flats = [], []
        for mg, fl, (dev, (r0, c0, h, w)) in zip(mag, flats, self._pieces()):
            sel = (i >= r0) & (i < r0 + h) & (j >= c0) & (j < c0 + w)
            if sel.any():
                loc = self._to_dev((i[sel] - r0) * w + j[sel] - c0, dev)
                fl = fl.reshape(-1).clone()
                fl[loc] = False
                fl = fl.view(h, w)
                mg = mg.reshape(-1).clone()
                mg[loc] = self._to_dev(vals[sel], dev)
                mg = mg.view(h, w)
            out_mag.append(mg)
            out_flats.append(fl)
        return out_mag, out_flats

    def _run_fused_device(self):
        """Whole post-conditioning pipeline device-resident: one elev
        upload, slope/flats/UCA/TWI computed on the devices, outputs
        streamed down once.  Halves the host↔device traffic of the staged
        path (no aspect/flats re-upload for UCA, no uca_state/flats/slope
        re-upload for finalize); the pit-link stage's flats/slope mutations
        come back as a tiny index scatter instead of canvases.  With a mesh
        every stage runs per shard (the slope program through
        ``parallel.sharded._slope_shards``).  Bit-identical to the staged
        path where there are no pit links (the same functions on the same
        values, pixel by pixel)."""
        from .parallel.sharded import _slope_shards

        wd = default_dtype(self.device)
        state_fn = os.path.join(self.store.root, "_oocore_uca.json")

        with self._stage("condition"):
            self.condition()

        with self._stage("slope_direction"):
            elev = self._gather_canvas("elev", wd, fill=np.nan)
            if self.mesh is None:
                mag, direction, flats = ([t] for t in _slope_program(
                    elev[0], self._to_dev(self.dX), self._to_dev(self.dY)))
            else:  # elev becomes the shards' elevation windows
                mag, direction, flats, elev = _slope_shards(
                    elev, self.dX, self.dY, self.mesh)
            self._scatter_canvas("slope", mag)
            self._scatter_canvas("aspect", direction)
            self._scatter_canvas("flats", flats, dtype="bool", fill=False)

        with self._stage("pit_links"):
            self.pit_links()
        dri, drm = self._drained if self._drained is not None else (
            np.zeros(0, "int64"), np.zeros(0, "float64"))
        # apply the pit-link flats/mag mutations on the devices (the store
        # copies were updated by pit_links on the host)
        if dri.size:
            mag, flats = self._drain_pieces(mag, flats, dri, drm)

        with self._stage("uca"):
            rounds, x = self._uca_device_resident(
                state_fn, elev=elev, direction=direction, flats=flats)
        del elev, direction

        with self._stage("finalize"):
            uca, twi = zip(*(self._finalize_program(*a)
                             for a in zip(x, flats, mag)))
            self._scatter_canvas("uca", uca)
            self._scatter_canvas("twi", twi)
        return rounds

    def run(self):
        """elev_src → conditioned elev → slope/aspect/flats → pit links →
        UCA rounds → uca/twi.  Bounded host memory in both regimes; with
        the canvases inside the device budget the post-conditioning stages
        fuse into one device-resident pass (``_run_fused_device``),
        otherwise every stage streams super-blocks through the store."""
        state_fn = os.path.join(self.store.root, "_oocore_uca.json")
        if self.resume and "twi" in self.store and os.path.exists(state_fn):
            with open(state_fn) as f:
                self.uca_rounds = json.load(f)["round"]
            return
        # the fused pass computes slope and direction on the whole canvas; a
        # mesh's pad would move the canvas edge, whose facet subsets are
        # positional, so a padded mesh run takes the staged stages
        np_, mp_, _mesh = self._padded_dims()
        if (self._fits_device_resident() and (np_, mp_) == self.shape
                and not (self.resume and "uca_state" in self.store)):
            self._run_fused_device()
            return
        with self._stage("condition"):
            self.condition()
        with self._stage("slope_direction"):
            self.slope_direction()
        with self._stage("pit_links"):
            self.pit_links()
        with self._stage("uca"):
            self.uca()
        with self._stage("finalize"):
            self.finalize()
