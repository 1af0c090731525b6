"""The terrain step on one device and over a mesh of devices.

Port of ``pydem_tpu/parallel/sharded.py``.  ``terrain_pre`` and
``terrain_step`` run on the device of their input.  The mesh functions run
over a :class:`~pydem_tpu_torch.parallel.mesh.Mesh`: the canvas is a list of
shards, one per mesh cell, and everything that crosses a shard's edge goes
through the mesh's exchange (``halo`` for the 1-px rings the JAX version
moves with ``ppermute``, ``reduce`` for its ``psum``), in this process
(every shard here, one GPU a shard or several on one) or over
``torch.distributed`` (one shard per rank, :mod:`.multihost`).

- :func:`label_flood_sharded`: local components first, then outer halo
  rounds of ``(id + 1, rep)`` rings adopted at component granularity by one
  shard-local scatter-min, until no shard changes (the JAX algorithm).
- :func:`terrain_pre` with ``mesh``: the pre-stencils per shard on its
  window with a 1-px halo of elevation (none on a side where the canvas
  ends: the facet masks and the edge copies of ``slopes_directions`` are
  positional, so a window's rim must be the canvas edge or lie outside the
  shard), the flat extension on exchanged label and representative rings,
  the receiver weights on the same window.  Every output pixel is computed
  from the same values by the same operations as on one canvas: equal bit
  for bit.
- :func:`accumulate_sharded` / :func:`accumulate_sharded_pits`: each shard
  is a K1 region with a 1-px ring; a round exchanges the canvas's rings and
  runs K1 in the TPU's order on each shard's canvas, in place
  (``ops.uca_block.gs_round_oriented(..., ring=True)``), round r at
  orientation r % 4, every block every round (no frontier, as the JAX
  solver threads none: in the TPU's order a skip decided from last round's
  flags is not the JAX round, since an earlier neighbour can change in
  this very round).  Each shard runs its own sequential grid against a
  ring frozen at the round's start, as the JAX solver's shards do, so the
  rounds depend on the mesh's shape and equal the JAX solver's on the same
  mesh and B.  Every shape reaches the fixed point of one device's in-core
  solve (``accumulate_blocked_gs``) bit for bit; a 1×1 mesh differs from
  that solve only in the frontier the in-core solver threads, which can
  change its round count (the 4096² cone: 6 rounds against 5).  Pit links fold into each shard's
  effective base before each round in link order, the fold of
  ``PitLinks``; the compact receivers are exchanged once.
- The *split round*: a shard's interior blocks (``subset="interior"``,
  which never read the ring) relax in place on the shard's own CUDA
  stream, on the shard's card, while each card's copy stream lands the
  rings, then its frame (``"boundary"``) at the same orientation against
  the landed ring.  It is not the serial round (there the frame blocks are
  visited among the interior ones), as in the JAX package, which splits
  only on a TPU.  The choice is the solver's, no caller's
  (:func:`_use_split`: shards of one card).
- Results stay on their shards: every mesh function returns its canvases
  as :class:`~pydem_tpu_torch.parallel.mesh.ShardedCanvas`es (the shards
  on their cells' devices, the logical shape beside them), as the JAX
  functions return arrays laid over the mesh, and takes a whole canvas (on
  any device or the host, copied shard by shard to the cells) or a
  ``ShardedCanvas``.  None assembles a canvas on one device; the caller
  does, if it wants one (``.assemble()``, ``.numpy()``,
  ``np.asarray``).  Where the blocked solver needs shards of whole K1
  blocks and the mesh's are not, base and receivers are re-cut onto the
  shards of the canvas zero-padded to whole blocks through the mesh's
  exchange (``recut``), as the engine's solve re-cuts them, and the area
  cut back.
- :func:`measure_halo_overlap` times exchange-only, relax-only and full
  rounds (CUDA events on one card, the host clock around a synchronise of
  every card over several, the host clock on the CPU) and reports the
  share of the cheaper phase hidden behind the other.  On shards that share
  one card that is a one-card figure, not an interconnect's.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_dtype
from ..core.flats_device import fill_flats_device
from ..core.receivers import (receiver_weights, section_proportion,
                              section_theta)
from ..core.slope_direction import (find_flats_edges, label_flood,
                                    slopes_directions)
from ..core.stencil import NEIGHBOR_OFFSETS
from ..core.twi import twi as twi_fn
from ..core.uca import accumulate, base_area, finalize_uca, flow_sweep
from ..profiling import count, span
from .mesh import (Mesh, ShardedCanvas, layout, make_mesh, same_mesh,
                   shard_dims)
from .mesh import split as _split

__all__ = ["Mesh", "ShardedCanvas", "make_mesh", "label_flood_sharded",
           "terrain_pre",
           "terrain_post", "terrain_step", "accumulate_sharded",
           "accumulate_sharded_pits", "sharded_uca", "ShardedPipeline",
           "measure_halo_overlap", "run_sharded"]

FLAT_ID_INT = -1


def _block_size(n, m):
    """Relaxation block side: the JAX ``terrain_step``'s and
    ``DEMProcessor``'s rule, 256, or 128 for canvases under 256 on a side,
    on every device (the plain rounds take any B; on a GPU a visit at 128
    or 256 runs on a thread-block cluster), so the blocked solvers return
    the JAX package's rounds.  B = 64 and 16 stay callable
    (``block_size=``, ``B=``)."""
    return 256 if min(n, m) >= 256 else 128


def _nanmin(a):
    # torch has no NaN-ignoring min
    return torch.where(torch.isnan(a), torch.inf, a).min()


def _check_on(canvas, mesh):
    if not same_mesh(canvas.mesh, mesh):
        raise ValueError("the canvas is laid over %r, not over %r"
                         % (canvas.mesh, mesh))


def _canvas_shards(canvas, mesh):
    """The shards this process owns of ``canvas`` over ``mesh``: a
    :class:`ShardedCanvas`'s own, or a whole canvas (on any device or the
    host) split.  The mesh must divide the canvas."""
    if isinstance(canvas, ShardedCanvas):
        _check_on(canvas, mesh)
        if canvas.shape != canvas.padded_shape:
            raise ValueError("a %s canvas in shards of a %s one: the mesh "
                             "must divide the canvas"
                             % (canvas.shape, canvas.padded_shape))
        return canvas.local_shards()
    return _split(canvas, mesh)


def _min_area(base):
    """The smallest base area of the canvas ``base`` (a
    :class:`ShardedCanvas`, its padding left out) over the mesh, NaN
    ignored: a device scalar on the first device."""
    vals = [_nanmin(v) if v.numel() else
            torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
            for v, _piece in base.views()]
    return base.mesh.exchange().reduce(vals, "min")


def terrain_pre(elev, dX, dY, dX2, dY2, fill_flats=False, mesh=None):
    """The stencil first half of the terrain step: slope/direction, flat
    extension, flow splitting, receiver weights, base area, on the device of
    ``elev``; with ``fill_flats``, the elevation is first conditioned by
    :func:`~pydem_tpu_torch.core.flats_device.fill_flats_device`.  Returns
    ``(mag, direction, flats, W, base)``.

    ``mesh``: ``elev`` is a whole canvas (on any device or the host) or a
    :class:`ShardedCanvas` over ``mesh``; the stencils run per shard (see
    the module docstring) and the flat regions are labelled by
    :func:`label_flood_sharded`.  The outputs are ``ShardedCanvas``es
    over the mesh (``W``: ``(8, n, m)``), equal to the unsharded ones bit
    for bit.  Flat filling is a global flood and runs on the whole canvas
    first, so it needs ``elev`` whole.  The mesh must divide the canvas
    (``run_sharded`` pads)."""
    with span("pre"):
        if mesh is not None:
            if fill_flats:
                if isinstance(elev, ShardedCanvas):
                    raise ValueError("fill_flats over a mesh fills the "
                                     "whole canvas first: pass elev whole")
                elev = fill_flats_device(torch.as_tensor(elev))
            pre = _pre_shards(_canvas_shards(elev, mesh), dX, dY, dX2, dY2,
                              mesh)
            return tuple(ShardedCanvas(pre[k], mesh)
                         for k in ("mag", "direction", "flats", "W", "base"))
        dX, dY, dX2, dY2 = (torch.as_tensor(a, dtype=elev.dtype,
                                            device=elev.device)
                            for a in (dX, dY, dX2, dY2))
        if fill_flats:
            elev = fill_flats_device(elev)
        with span("slopes"):
            mag, direction = slopes_directions(elev, dX, dY)
        with span("flats"):
            flats = find_flats_edges(elev, mag)
        direction = torch.where(flats, FLAT_ID_INT, direction)
        mag = torch.where(flats, FLAT_ID_INT, mag)
        with span("section"):
            section, proportion = section_proportion(direction, flats, dX, dY)
        with span("receivers"):
            W = receiver_weights(section, proportion, elev)
        base = base_area(dX2, dY2, elev.shape, elev.dtype)
        return mag, direction, flats, W, base


def terrain_post(area, flats, mag, base):
    """``(uca, twi)`` from the solved area: NaN at flats, and the TWI with
    the smallest base area.  On :class:`ShardedCanvas`es of one mesh and
    layout: per shard, the smallest base area over the mesh (the canvas's,
    its padding left out), two ``ShardedCanvas``es back."""
    if isinstance(area, ShardedCanvas):
        for c in (flats, mag, base):
            _check_on(c, area.mesh)
            if c.padded_shape[-2:] != area.padded_shape[-2:]:
                raise ValueError("canvases in shards of %s and %s"
                                 % (area.padded_shape, c.padded_shape))
        uca_s, twi_s = _post_shards(area.local_shards(), flats.local_shards(),
                                    mag.local_shards(), base)
        return (ShardedCanvas(uca_s, area.mesh, area.shape),
                ShardedCanvas(twi_s, area.mesh, area.shape))
    uca = finalize_uca(area, flats)
    return uca, twi_fn(uca, mag, _nanmin(base))


def terrain_step(elev, dX, dY, dX2, dY2, n_sweeps=None, uca_solver="jacobi",
                 fill_flats=False):
    """(Flat filling →) slope/direction → flats → section/proportion →
    receiver weights → UCA fixed point → TWI, on the device of ``elev``.

    With ``n_sweeps`` set, runs that many UCA sweeps; otherwise iterates to
    the fixed point with ``uca_solver``: ``"jacobi"`` (global sweeps) or
    ``"blocked"`` (K1's rounds in the TPU kernel's Gauss-Seidel order,
    ``ops.uca_block.accumulate_blocked_gs``: one dataflow launch of the
    CUDA kernel a round on a GPU; the canvas is zero-padded to the block
    grid, which is exact since pad pixels carry no weight and no base
    area).  The block side is :func:`_block_size`'s, the JAX function's
    (256, or 128 on small canvases), so ``uca_sweeps`` is the JAX
    function's rounds.  Returns a dict
    with ``mag``, ``direction``, ``flats``, ``uca``, ``twi`` and
    ``uca_sweeps`` (sweeps, or rounds for the blocked solver, as an int).
    """
    if uca_solver not in ("jacobi", "blocked"):
        raise ValueError("uca_solver must be 'jacobi' or 'blocked', got %r"
                         % (uca_solver,))
    with span("terrain_step"):
        mag, direction, flats, W, base = terrain_pre(elev, dX, dY, dX2, dY2,
                                                     fill_flats=fill_flats)

        if n_sweeps is not None:
            area = base
            for _ in range(n_sweeps):
                area = base + flow_sweep(area, W)
            sweeps = n_sweeps
        elif uca_solver == "blocked":
            from ..ops.uca_block import accumulate_blocked_gs

            n, m = elev.shape
            B = _block_size(n, m)
            pn, pm = (-n) % B, (-m) % B
            with span("pad"):
                base_p = F.pad(base, (0, pm, 0, pn))
                W_p = F.pad(W, (0, pm, 0, pn))
            area, sweeps = accumulate_blocked_gs(base_p, W_p, B=B)
            area = area[:n, :m]
        else:
            area, sweeps = accumulate(base, W)
        with span("post"):
            uca, twi = terrain_post(area, flats, mag, base)
    return dict(mag=mag, direction=direction, flats=flats, uca=uca, twi=twi,
                uca_sweeps=sweeps)


# -- the sharded label flood ------------------------------------------------

def _ringed(shards, fill, depth=1):
    return [F.pad(s, (depth,) * 4, value=fill) for s in shards]


def _label_dtype(pixels):
    """The labels' dtype for a canvas of ``pixels``: int32, or int64 from
    2^31 pixels on (the JAX version's choice; a label is a flat index)."""
    return torch.int32 if pixels < 2 ** 31 else torch.int64


def _flood_shards(mask_s, pay_s, mesh):
    """:func:`label_flood_sharded` on shards."""
    ex = mesh.exchange()
    gy, gx = mesh.shape
    n_l, m_l = mask_s[0].shape
    n, m = n_l * gy, m_l * gx
    N, NL = n * m, n_l * m_l
    idt = _label_dtype(N)
    BIG = N
    state = []
    for (iy, ix), mask, pay in zip(mesh.local_shards(), mask_s, pay_s):
        dev = mask.device
        # phase 1: local components (every scatter and gather in the shard)
        loc, _rep = label_flood(mask, pay)
        loc = torch.where(mask, loc, NL).reshape(-1).long()
        li = torch.arange(n_l, device=dev)[:, None] + iy * n_l
        lj = torch.arange(m_l, device=dev)[None, :] + ix * m_l
        # per-component tables indexed by local root label (+ a sentinel);
        # non-root entries hold their own pixel's id and are never read
        gid_t = torch.cat([(li * m + lj).reshape(-1),
                           torch.tensor([BIG], device=dev)])
        rep_t = torch.cat([pay.reshape(-1),
                           torch.tensor([float("nan")], dtype=pay.dtype,
                                        device=dev)])
        state.append([mask, loc, gid_t, rep_t])

    while True:
        enc_r, rep_r = [], []
        for mask, loc, gid_t, rep_t in state:
            gid_px = gid_t[loc].view(n_l, m_l)
            # exchange (id + 1, rep): the ring's 0 where the canvas ends
            # decodes to "no neighbour"
            enc_r.append(F.pad(torch.where(mask, gid_px + 1, 0), (1,) * 4))
            rep_r.append(F.pad(rep_t[loc].view(n_l, m_l), (1,) * 4))
        ex.halo(enc_r)
        ex.halo(rep_r)
        changed = []
        for st, gh, rh in zip(state, enc_r, rep_r):
            mask, loc, gid_t, rep_t = st
            gh = torch.where(gh == 0, BIG + 1, gh) - 1
            cand_g = torch.full((n_l, m_l), BIG, dtype=gh.dtype,
                                device=gh.device)
            cand_r = torch.zeros((n_l, m_l), dtype=rep_t.dtype,
                                 device=gh.device)
            for di, dj in NEIGHBOR_OFFSETS:  # smallest 8-neighbour id
                qg = gh[1 + di: 1 + di + n_l, 1 + dj: 1 + dj + m_l]
                qr = rh[1 + di: 1 + di + n_l, 1 + dj: 1 + dj + m_l]
                better = qg < cand_g
                cand_g = torch.where(better, qg, cand_g)
                cand_r = torch.where(better, qr, cand_r)
            cand_g = torch.where(mask, cand_g, BIG).reshape(-1)
            # adopt smaller ids at component granularity (scatter-min; an
            # order-free reduction, deterministic on CUDA)
            new_t = gid_t.clone().scatter_reduce_(0, loc, cand_g, "amin")
            # the rep follows its id: pixels whose candidate won write it
            # (ties share the id, hence the region and the same rep)
            win = cand_g == new_t[loc]
            tgt = torch.where(win & mask.reshape(-1), loc, NL)
            rep_t2 = rep_t.clone()
            rep_t2[tgt] = torch.where(win, cand_r.reshape(-1), rep_t[tgt])
            changed.append((new_t != gid_t).any().to(torch.int32))
            st[2], st[3] = new_t, rep_t2
        if int(ex.reduce(changed)) == 0:
            break
    lbl_s, rep_s = [], []
    for mask, loc, gid_t, rep_t in state:
        lbl_s.append(torch.where(mask, gid_t[loc].view(n_l, m_l), BIG)
                     .to(idt))
        rep_s.append(torch.where(mask, rep_t[loc].view(n_l, m_l),
                                 float("nan")))
    return lbl_s, rep_s


def label_flood_sharded(mask, payload, mesh):
    """Connected-component min-index labels and the representative payload,
    as :func:`~pydem_tpu_torch.core.slope_direction.label_flood` gives them
    (label = the region's smallest global flat index, int32 (int64 on a
    canvas of 2^31 pixels or more), ``n*m`` off the mask; rep = the payload
    there, NaN off the mask), computed over ``mesh`` without a global
    scatter or gather:

    1. each shard labels its local components with ``label_flood``;
    2. per-component ``(global id, rep)`` tables then converge through outer
       rounds: the shards exchange their pixels' ``(id + 1, rep)`` rings,
       adopt the smallest neighbouring id with its rep by one shard-local
       scatter-min, and the sum of the changed flags over the mesh decides
       whether another round runs.

    Outer rounds scale with the shard-graph diameter of the largest region,
    not its pixel diameter.  ``mask``, ``payload``: whole canvases (on any
    device or the host) or :class:`ShardedCanvas`es over ``mesh``, which
    must divide the canvas.  Returns ``(labels, rep)`` as
    ``ShardedCanvas``es."""
    lbl_s, rep_s = _flood_shards(_canvas_shards(mask, mesh),
                                 _canvas_shards(payload, mesh), mesh)
    return ShardedCanvas(lbl_s, mesh), ShardedCanvas(rep_s, mesh)


# -- the pre-stencils per shard ---------------------------------------------

# Depth of the elevation halo of a shard's pre-stencil window.  Slope and
# direction are exact at pixels one or more away from the window's rim (the
# rim is where the edge facet subsets and the edge copies apply), and the
# receiver weights read the 8 neighbours' elevations; the flat extension
# reads the neighbours' labels and representatives, which are exchanged.
PRE_HALO = 1


def _window(iy, ix, mesh, halo):
    """The halo on each side (top, bottom, left, right) of shard (iy, ix):
    ``halo``, or 0 where the canvas ends."""
    gy, gx = mesh.shape
    return (halo if iy > 0 else 0, halo if iy < gy - 1 else 0,
            halo if ix > 0 else 0, halo if ix < gx - 1 else 0)


def _vector(cache, name, a, dt, dev):
    """A row vector of the canvas on ``dev`` in ``dt``, made once per
    ``cache``."""
    key = (name, dev)
    if key not in cache:
        cache[key] = torch.as_tensor(a, dtype=dt).to(dev)
    return cache[key]


def _elev_windows(elev_s, mesh, halo=PRE_HALO):
    """Each shard's elevation window: the shard with ``halo`` px of its
    neighbours' elevation (exchanged), none on a side where the canvas
    ends.  Returns ``[(E, (top, bottom, left, right)), ...]``, the halo on
    each side beside the window."""
    n_l, m_l = elev_s[0].shape
    er = _ringed(elev_s, float("nan"), halo) if halo else list(elev_s)
    if halo:
        mesh.exchange().halo(er, halo)
    wins = []
    for (iy, ix), e in zip(mesh.local_shards(), er):
        top, bot, left, right = _window(iy, ix, mesh, halo)
        wins.append((e[halo - top: halo + n_l + bot,
                       halo - left: halo + m_l + right],
                     (top, bot, left, right)))
    return wins


def _slope_shards(elev_s, dX, dY, mesh, halo=PRE_HALO, vec=None):
    """Slope, direction and the extended flats per shard, as
    ``api._slope_program`` gives them on the whole canvas: the facet sweep
    on each shard's elevation window, the flat extension on exchanged label
    and representative rings.  ``dX``/``dY``: the canvas's (n-1) row
    vectors.  Returns ``(mag_s, dir_s, flats_s, wins)``, ``wins`` those of
    :func:`_elev_windows`."""
    ex = mesh.exchange()
    gy, _gx = mesh.shape
    n_l, m_l = elev_s[0].shape
    dt = elev_s[0].dtype
    vec = {} if vec is None else vec
    wins = _elev_windows(elev_s, mesh, halo)
    mag_s, dir_s = [], []
    for (iy, _ix), (E, (top, bot, left, _right)) in zip(mesh.local_shards(),
                                                        wins):
        dev = E.device
        r0, r1 = iy * n_l - top, (iy + 1) * n_l + bot
        mag, direction = slopes_directions(
            E, _vector(vec, "dX", dX, dt, dev)[r0: r1 - 1],
            _vector(vec, "dY", dY, dt, dev)[r0: r1 - 1])
        crop = (slice(top, top + n_l), slice(left, left + m_l))
        mag_s.append(mag[crop])
        dir_s.append(direction[crop])
    flat_s = [mg == FLAT_ID_INT for mg in mag_s]
    lbl_s, rep_s = _flood_shards(flat_s, elev_s, mesh)
    # the flat extension reads the 8 neighbours' labels and reps
    lr = [F.pad(torch.where(f, lb, -1), (1,) * 4, value=-1)
          for f, lb in zip(flat_s, lbl_s)]
    rr = _ringed(rep_s, float("nan"))
    ex.halo(lr)
    ex.halo(rr)
    out_mag, out_dir, out_flats = [], [], []
    for k, (flat, e) in enumerate(zip(flat_s, elev_s)):
        dev = e.device
        best_lbl = torch.full((n_l, m_l), -1, dtype=torch.int32, device=dev)
        best_rep = torch.full_like(e, float("nan"))
        for di, dj in NEIGHBOR_OFFSETS:
            nl = lr[k][1 + di: 1 + di + n_l, 1 + dj: 1 + dj + m_l]
            nr = rr[k][1 + di: 1 + di + n_l, 1 + dj: 1 + dj + m_l]
            better = nl > best_lbl
            best_lbl = torch.where(better, nl, best_lbl)
            best_rep = torch.where(better, nr, best_rep)
        flats = torch.where(best_lbl >= 0, e == best_rep, flat)
        out_dir.append(torch.where(flats, FLAT_ID_INT, dir_s[k]))
        out_mag.append(torch.where(flats, FLAT_ID_INT, mag_s[k]))
        out_flats.append(flats)
    return out_mag, out_dir, out_flats, wins


def _weights_shards(dir_s, flats_s, wins, theta_s):
    """The dense receiver weights of each shard: its section and proportion
    (``theta_s``: the facet angle of each of its rows), padded with a flat's
    over the window's halo, against the elevation window (``wins`` of
    :func:`_elev_windows`); every weight is that of the whole canvas."""
    W_s = []
    for direction, flats, (E, (top, bot, left, right)), theta in zip(
            dir_s, flats_s, wins, theta_s):
        n_l, m_l = direction.shape
        section, proportion = section_proportion(direction, flats,
                                                 theta=theta)
        pad = (left, right, top, bot)
        W = receiver_weights(F.pad(section, pad, value=FLAT_ID_INT),
                             F.pad(proportion, pad, value=float("nan")), E)
        W_s.append(W[:, top: top + n_l, left: left + m_l].contiguous())
    return W_s


def _pre_shards(elev_s, dX, dY, dX2, dY2, mesh, halo=PRE_HALO):
    """``terrain_pre`` on shards: a dict of per-shard lists ``mag``,
    ``direction``, ``flats``, ``W``, ``base``.  ``dX``/``dY`` (n-1) and
    ``dX2``/``dY2`` (n) are the whole canvas's row vectors.  ``halo``: the
    elevation halo (``PRE_HALO``; less is wrong at the shards' edges)."""
    gy, _gx = mesh.shape
    n_l, m_l = elev_s[0].shape
    n = n_l * gy
    dt = elev_s[0].dtype
    vec = {}
    mag_s, dir_s, flats_s, wins = _slope_shards(elev_s, dX, dY, mesh, halo,
                                                vec)
    theta_c, theta_s, base_s = {}, [], []
    for (iy, _ix), (E, _pads) in zip(mesh.local_shards(), wins):
        dev = E.device
        if dev not in theta_c:
            theta_c[dev] = section_theta(_vector(vec, "dX", dX, dt, dev),
                                         _vector(vec, "dY", dY, dt, dev),
                                         n)[:, 0]
        i0 = iy * n_l
        theta_s.append(theta_c[dev][i0: i0 + n_l])
        dx2, dy2 = (_vector(vec, k, a, dt, dev)[i0: i0 + n_l]
                    for k, a in (("dX2", dX2), ("dY2", dY2)))
        base_s.append(base_area(dx2, dy2, (n_l, m_l), dt))
    return dict(mag=mag_s, direction=dir_s, flats=flats_s,
                W=_weights_shards(dir_s, flats_s, wins, theta_s), base=base_s)


# -- the sharded UCA solvers ------------------------------------------------

def _shard_block_size(n_l, m_l):
    """The K1 block size for an n_l × m_l shard: the largest of 256, 128,
    64, 32, 16 and 8 that divides both (the JAX function's rule); None if
    none does."""
    for B in (256, 128, 64, 32, 16, 8):
        if n_l % B == 0 and m_l % B == 0:
            return B
    return None


class _ShardedLinks:
    """Pit links over shards, folded as :class:`~pydem_tpu_torch.core.uca.
    PitLinks` folds them on one canvas: sorted stably by destination, each
    destination's contributions added one at a time in link order, on the
    first shard's device, so the sum equals the one-canvas fold bit for
    bit.  ``src``/``dst`` are flat indices into the (n, m) canvas the
    shards tile; ``w`` their weights.  Over ``torch.distributed`` every rank
    fills the contributions of its own shard and an ``all_reduce`` sums
    them, then every rank folds them all and keeps its own
    destinations."""

    def __init__(self, src, dst, w, mesh, n_l, m_l, dtype):
        gx = mesh.shape[1]
        self.ex = mesh.exchange() if mesh.distributed else None
        self.dev = mesh.devices[mesh.local_shards()[0]]
        m = m_l * gx
        dst = torch.as_tensor(dst).long().to(self.dev)
        dst_sorted, order = torch.sort(dst, stable=True)
        src = torch.as_tensor(src).long().to(self.dev)[order]
        w = torch.as_tensor(w).to(self.dev, dtype)[order]
        dst_u, inverse, counts = torch.unique_consecutive(
            dst_sorted, return_inverse=True, return_counts=True)
        self.width = int(counts.max()) if counts.numel() else 0
        start = torch.cumsum(counts, 0) - counts
        self.slot = inverse * self.width + (
            torch.arange(dst_sorted.numel(), device=self.dev) - start[inverse])
        self.n_links, self.n_dst = src.numel(), dst_u.numel()
        self.parts = []
        for iy, ix in mesh.local_shards():
            dev = mesh.devices[iy, ix]

            def local(idx):
                i, j = idx // m - iy * n_l, idx % m - ix * m_l
                sel = (i >= 0) & (i < n_l) & (j >= 0) & (j < m_l)
                return sel.nonzero()[:, 0], i[sel], j[sel]

            ls, si, sj = local(src)
            ld, di, dj = local(dst_u)
            self.parts.append(dict(
                links=ls, w=w[ls].to(dev),
                src=((si + 1) * (m_l + 2) + sj + 1).to(dev),  # ringed x
                dsts=ld, dst=(di * m_l + dj).to(dev)))

    def __len__(self):
        return self.n_links

    def add_to(self, out_s, xp_s):
        """Per-shard ``out`` plus the links' inflow from the ringed canvases
        ``xp_s`` (new tensors)."""
        c = torch.zeros(self.n_links, dtype=out_s[0].dtype, device=self.dev)
        acc = torch.zeros(self.n_dst, dtype=out_s[0].dtype, device=self.dev)
        for p, xp, o in zip(self.parts, xp_s, out_s):
            c[p["links"]] = (xp.reshape(-1)[p["src"]] * p["w"]).to(self.dev)
            acc[p["dsts"]] = o.reshape(-1)[p["dst"]].to(self.dev)
        if self.ex is not None:  # each rank filled its own entries (x + 0
            self.ex.sum_(c)      # is x: the sums are exact)
            self.ex.sum_(acc)
        table = c.new_zeros(self.n_dst * self.width)
        table[self.slot] = c  # unique slots
        table = table.view(-1, self.width)
        for r in range(self.width):
            acc = acc + table[:, r]
        res = []
        for p, o in zip(self.parts, out_s):
            flat = o.reshape(-1).clone()
            flat[p["dst"]] = acc[p["dsts"]].to(o.device)
            res.append(flat.view(o.shape))
        return res


def _one_card(mesh):
    return mesh.device_type == "cuda" and mesh.distinct_devices == 1 \
        and not mesh.distributed


class _ShardRounds:
    """The per-shard state of K1 ring rounds in the TPU's order over a mesh
    (``ops.uca_block.gs_round_oriented(..., ring=True)``): each shard's
    canvas with its 1-px ring, relaxed in place; its compact receivers with
    the neighbours' (exchanged once); all-ones flags, since the rounds
    thread no frontier (every block relaxes every round, as in the JAX
    solver); and, for the split round on CUDA, a stream per shard on the
    shard's card, a copy stream per card, and the events that order them:
    each card's round start, each card's landed rings, each shard's end."""

    def __init__(self, mesh, base_s, K_s, W1_s, B, inner_max, split,
                 round_fn=None):
        from ..ops.uca_block import FORMS, _device_table, gs_round_oriented

        self.mesh, self.ex, self.B, self.inner_max = (
            mesh, mesh.exchange(), B, inner_max)
        self.round_fn = round_fn or gs_round_oriented
        n_l, m_l = base_s[0].shape
        self.nb = (n_l // B, m_l // B)
        self.kp = self.ex.halo(_ringed(K_s, 255))  # "no edge" off the canvas
        self.w1p = self.ex.halo(_ringed(W1_s, 0.0))
        self.x = _ringed([b.contiguous() for b in base_s], 0.0)
        self.prev = [torch.ones(self.nb, dtype=torch.int32, device=b.device)
                     for b in base_s]
        self.split = split
        if split and mesh.device_type == "cuda":
            self.cards = mesh.devices_of()
            for dev, _ks in self.cards:  # built before the streams use them
                for subset in FORMS:
                    for o in range(4):
                        _device_table(*self.nb, o, subset, dev)
            self.streams = [torch.cuda.Stream(mesh.devices[cell])
                            for cell in mesh.local_shards()]
            self.copy_streams = {dev: torch.cuda.Stream(dev)
                                 for dev, _ks in self.cards}
            # an event belongs to the card whose stream first records it
            self.done = [torch.cuda.Event() for _ in base_s]
            self.start = {dev: torch.cuda.Event() for dev, _ks in self.cards}
            self.landed = {dev: torch.cuda.Event() for dev, _ks in self.cards}
            for dev, _ks in self.cards:
                torch.cuda.current_stream(dev).synchronize()

    def exchange(self):
        self.ex.halo(self.x)

    def _relax(self, k, b, o, subset="all"):
        """Shard ``k``'s round (of ``subset``) at orientation ``o``, in
        place; returns its flags."""
        _x, chg = self.round_fn(
            self.x[k], self.kp[k], self.w1p[k], b, o, B=self.B,
            inner_max=self.inner_max, prev=self.prev[k], ring=True,
            subset=subset, inplace=True)
        return chg

    def round(self, b_s, o, mode="full"):
        """One round at orientation ``o``: ``"full"`` (exchange, relax),
        ``"exchange"`` or ``"relax"`` alone (for timing).  Returns the
        number of changed blocks over the mesh (a device scalar) for
        ``"full"``."""
        if mode == "exchange":
            self.exchange()
            return None
        if not self.split:
            if mode == "full":
                self.exchange()
            chg = [self._relax(k, b, o) for k, b in enumerate(b_s)]
        else:
            chg = self._split_round(b_s, o, mode)
        if mode != "full":
            return None
        return self.ex.reduce([c.sum() for c in chg])

    def _split_round(self, b_s, o, mode):
        """Interior blocks on each shard's stream while each card's copy
        stream lands the rings; then each shard's frame, at the same
        orientation.  Returns the flags of both.

        Both run in place on the shard's canvas, as the JAX split round's
        two subset calls do.  The interior blocks never read the ring and
        never write the shard's edge rows and columns (those belong to the
        frame's blocks), and the ring copies read only those edge rows and
        columns and write only the ring: so the two never race, and the
        rings that land are the round-start values the serial round would
        exchange.  It is not the serial round: there the frame blocks are
        visited among the interior ones, here after all of them.  On CUDA,
        per card: the round starts with an event on the card's current
        stream (after the previous round and the fold); the copy streams of
        every card wait for every card's start (a ring copy reads one card
        and writes another) and are made current on their cards for the
        exchange, so each cross-card ``copy_`` is ordered between two copy
        streams; a card's rings have landed when its copy stream has passed
        them (it waits for the copies into the card).  A shard's frame
        waits for its card's landed rings, and each card's current stream
        waits for its shards before the change counts are summed."""
        if self.mesh.device_type != "cuda":  # in order, on the host
            if mode != "full":
                return [self._relax(k, b, o) for k, b in enumerate(b_s)]
            chg = [self._relax(k, b, o, "interior")
                   for k, b in enumerate(b_s)]
            self.exchange()
            return chg + [self._relax(k, b, o, "boundary")
                          for k, b in enumerate(b_s)]
        for dev, _ks in self.cards:
            self.start[dev].record(torch.cuda.current_stream(dev))
        if mode == "full":
            with contextlib.ExitStack() as current:
                for dev, _ks in self.cards:
                    cs = self.copy_streams[dev]
                    for ev in self.start.values():
                        cs.wait_event(ev)
                    current.enter_context(torch.cuda.stream(cs))
                self.exchange()
                for dev, _ks in self.cards:
                    self.landed[dev].record(self.copy_streams[dev])
        chg = []
        for dev, ks in self.cards:
            for k in ks:
                s = self.streams[k]
                with torch.cuda.stream(s):
                    s.wait_event(self.start[dev])
                    if mode == "full":
                        chg.append(self._relax(k, b_s[k], o, "interior"))
                        s.wait_event(self.landed[dev])
                        chg.append(self._relax(k, b_s[k], o, "boundary"))
                    else:
                        chg.append(self._relax(k, b_s[k], o))
                    self.done[k].record(s)
        for dev, ks in self.cards:
            main = torch.cuda.current_stream(dev)
            for k in ks:
                main.wait_event(self.done[k])
        for c in chg:  # made on a shard's stream, summed on its card's
            c.record_stream(torch.cuda.current_stream(c.device))
        return chg


def _use_split(mesh, nb, force=None):
    """Whether the rounds split: with every shard on one card and at least
    3×3 blocks ``nb`` a shard.  Shards on several cards take the serial
    round: there the split round was measured slower than the serial one
    (``chip_smoke.py --multicard``, 12b: its per-card streams wait on every
    card's round start, and the launches double, which costs more than the
    cross-card exchange it hides).  The split round over several cards is
    kept all the same, bitwise equal to the serial one, as the start of
    making it pay there (ROADMAP); only ``force`` reaches it.  ``force``
    (tests and ``chip_smoke.py`` only) picks a branch; the split round then
    needs the 3×3 blocks and the CPU or the cards of one process."""
    big = nb[0] >= 3 and nb[1] >= 3
    if force is None:
        return big and _one_card(mesh)
    if force and not big:
        raise ValueError("split rounds need shards of at least 3x3 blocks, "
                         "got %dx%d" % nb)
    if force and mesh.distributed:
        raise ValueError("split rounds run on the CPU or on the cards of "
                         "one process")
    return bool(force)


# rounds the sharded solve enqueues between two reads of their change counts
ROUNDS_PER_READ = 4


def _blocked_shards(base_s, W_s, mesh, B, inner_max=None, max_rounds=100_000,
                    links=None, _force_split=None, _round_fn=None):
    """The sharded K1 solve on block-aligned shards (see the module
    docstring).  ``W_s``: dense (8, n_l, m_l) planes or ``(K, W1)`` pairs;
    ``links``: a :class:`_ShardedLinks` or None.  Round r (from 0) runs at
    orientation ``r % 4``, its pit links folded into the base from the
    round-start canvas; the loop ends with the first round that changed no
    block, as the JAX solver's does, and reads the counts on the host once
    per ``ROUNDS_PER_READ`` rounds (a round after a still one changes
    nothing: ``ops.uca_block._gs_solve``).  ``_force_split`` lets tests
    take the split or the serial round where :func:`_use_split` would pick
    the other, and ``_round_fn`` (``gs_round_oriented_plain``) the plain
    rounds on the card, to hold the kernel against them.  Returns ``(area
    shards, rounds)``."""
    from ..ops.uca_block import compact_from_dense

    n_l, m_l = base_s[0].shape
    if n_l % B or m_l % B:
        raise ValueError("shards %dx%d are not a multiple of the block size "
                         "%d" % (n_l, m_l, B))
    inner_max = 2 * B + 4 if inner_max is None else inner_max
    base_s = [b.contiguous() for b in base_s]
    KW = [w if isinstance(w, tuple) else compact_from_dense(w) for w in W_s]
    nb = (n_l // B, m_l // B)
    st = _ShardRounds(mesh, base_s, [k for k, _ in KW], [w for _, w in KW],
                      B, inner_max, _use_split(mesh, nb, _force_split),
                      _round_fn)
    _blocked_shards.last_split = st.split
    rounds = 0
    while True:
        counts = []
        for r in range(rounds, rounds + max(1, min(ROUNDS_PER_READ,
                                                   max_rounds - rounds))):
            b_s = base_s if links is None else links.add_to(base_s, st.x)
            counts.append(st.round(b_s, r % 4))
        counts = torch.stack(counts).tolist()
        count("mesh_solve_reads")
        if 0 in counts:
            rounds += counts.index(0) + 1
            break
        rounds += len(counts)
        if rounds >= max_rounds:
            break
    return [x[1:-1, 1:-1] for x in st.x], rounds


_blocked_shards.last_split = None


def _jacobi_shards(base_s, W_s, mesh, links=None, n_sweeps=None,
                   max_iters=1_000_000, check_every=4):
    """Jacobi sweeps over shards: ``core.uca.accumulate`` (or, with
    ``n_sweeps``, that many sweeps) with the canvas's ring exchanged before
    every sweep and the weights' once.  Each pixel's sum is the one-canvas
    sweep's, bit for bit.  Returns ``(area shards, sweeps)``."""
    ex = mesh.exchange()
    Wp = ex.halo(_ringed(W_s, 0.0))

    def sweep(x_s):
        xr = ex.halo(_ringed(x_s, 0.0))
        inflow = [flow_sweep(x, W)[1:-1, 1:-1] for x, W in zip(xr, Wp)]
        if links is not None:
            inflow = links.add_to(inflow, xr)
        return [b + f for b, f in zip(base_s, inflow)]

    x = list(base_s)
    if n_sweeps is not None:
        for _ in range(n_sweeps):
            x = sweep(x)
        return x, n_sweeps
    prev = [torch.full_like(b, -1.0) for b in base_s]
    it = 0
    while it < max_iters and int(ex.reduce(
            [(a != p).any().to(torch.int32) for a, p in zip(x, prev)])):
        new = x
        for _ in range(check_every):
            new = sweep(new)
        x, prev, it = new, x, it + check_every
    return x, it


def _check_solver(uca_solver):
    if uca_solver not in ("jacobi", "blocked"):
        raise ValueError("uca_solver must be 'jacobi' or 'blocked', got %r"
                         % (uca_solver,))


def _links_of(pit_links, mesh, n_l, m_l, dtype):
    if pit_links is None or not len(pit_links[0]):
        return None
    return _ShardedLinks(*pit_links, mesh, n_l, m_l, dtype)


def _recut_blocked(base_s, W_s, mesh, B):
    """``base`` and the compact receivers of ``W`` (dense planes or ``(K,
    W1)`` pairs) on the shards of their canvas, cut anew onto the shards of
    the canvas zero-padded to whole ``B``-blocks a shard (exact: pad pixels
    carry no base area and no weight), as the engine re-cuts its solve;
    the parts that change shard go through the mesh's exchange.  Returns
    ``(base shards, (K, W1) shards, the two layouts)``."""
    from ..ops.uca_block import compact_from_dense

    gy, gx = mesh.shape
    n_l, m_l = base_s[0].shape
    n, m = n_l * gy, m_l * gx
    src = layout(mesh, (n, m))
    dst = layout(mesh, (n + (-n) % (B * gy), m + (-m) % (B * gx)))
    ex = mesh.exchange()
    KW = [w if isinstance(w, tuple) else compact_from_dense(w) for w in W_s]
    k0, w0 = compact_from_dense(torch.zeros((8, 1, 1),
                                            dtype=base_s[0].dtype))
    K = ex.recut([k for k, _ in KW], src, dst, int(k0))
    W1 = ex.recut([w for _, w in KW], src, dst, float(w0))
    del KW
    base_q = ex.recut([b.contiguous() for b in base_s], src, dst, 0.0)
    return base_q, list(zip(K, W1)), src, dst


def _solve_shards(base_s, W_s, mesh, pit_links=None, uca_solver="blocked",
                  B=None):
    """The UCA fixed point on the shards of an (n, m) canvas (``pit_links``
    index it).  The blocked solver's block size ``B`` defaults to one
    device's for the whole canvas (:func:`_block_size`, the JAX rule), so
    that a 1×1 mesh solves as that device does (:func:`run_sharded` hands
    it the JAX ``run_sharded``'s, :func:`_shard_block_size` of the shard,
    where that has one).  It needs shards that are multiples of ``B``:
    others are re-cut onto whole blocks (:func:`_recut_blocked`) and the
    area cut back.  Nothing is assembled.  Returns ``(area shards,
    rounds)``."""
    _check_solver(uca_solver)
    n_l, m_l = base_s[0].shape
    dt = base_s[0].dtype
    if uca_solver == "jacobi":
        return _jacobi_shards(base_s, W_s, mesh,
                              _links_of(pit_links, mesh, n_l, m_l, dt))
    gy, gx = mesh.shape
    m = m_l * gx
    if B is None:
        B = _block_size(n_l * gy, m)
    if n_l % B == 0 and m_l % B == 0:
        return _blocked_shards(base_s, W_s, mesh, B,
                               links=_links_of(pit_links, mesh, n_l, m_l, dt))
    base_q, KW, src, dst = _recut_blocked(base_s, W_s, mesh, B)
    nq_l, mq_l = base_q[0].shape
    if pit_links is not None and len(pit_links[0]):
        s_, d_, w = (torch.as_tensor(v) for v in pit_links)
        mq = mq_l * gx  # flat indices into the padded canvas
        pit_links = ((s_ // m) * mq + s_ % m, (d_ // m) * mq + d_ % m, w)
    area_q, rounds = _blocked_shards(
        base_q, KW, mesh, B, links=_links_of(pit_links, mesh, nq_l, mq_l, dt))
    del base_q, KW
    return mesh.exchange().recut(area_q, dst, src, 0.0), rounds


def accumulate_sharded(base, W, mesh, B=None, inner_max=None,
                       max_rounds=100_000):
    """The UCA fixed point by K1 ring rounds over ``mesh`` (see the module
    docstring): ``base`` (n, m) and ``W`` (8, n, m), whole (on any device
    or the host) or :class:`ShardedCanvas`es, the mesh dividing the
    canvas into shards that are multiples of ``B`` (default: the largest of
    256, 128, 64, 32, 16 and 8 that fits, :func:`_shard_block_size`, the
    JAX function's rule); the split round runs
    where :func:`_use_split` picks it.  Returns ``(area, rounds)``, the
    area a ``ShardedCanvas``; the rounds are the JAX solver's on the same
    mesh and B, and the area is the fixed point of
    ``accumulate_blocked_gs(base, W, B=B)`` bit for bit."""
    base_s, W_s = _canvas_shards(base, mesh), _canvas_shards(W, mesh)
    n_l, m_l = base_s[0].shape
    B = _shard_block_size(n_l, m_l) if B is None else B
    if B is None:
        raise ValueError("shard %dx%d too small for the blocked solver"
                         % (n_l, m_l))
    area_s, rounds = _blocked_shards(base_s, W_s, mesh, B, inner_max,
                                     max_rounds)
    return ShardedCanvas(area_s, mesh), rounds


def accumulate_sharded_pits(base, W, mesh, pit_src, pit_dst, pit_w, B=None,
                            inner_max=None, max_rounds=100_000):
    """:func:`accumulate_sharded` with non-adjacent pit links (flat indices
    into the canvas, ``pit_src → pit_dst`` with weight ``pit_w``), folded
    into each shard's effective base at the start of every round as
    ``accumulate_blocked_pits_gs`` folds them on one canvas.  The compact
    receivers are exchanged once.  The rounds are the JAX solver's on the
    same mesh and B, and the area is the fixed point of
    ``accumulate_blocked_pits_gs`` bit for bit; the area a
    :class:`ShardedCanvas`."""
    base_s, W_s = _canvas_shards(base, mesh), _canvas_shards(W, mesh)
    n_l, m_l = base_s[0].shape
    B = _shard_block_size(n_l, m_l) if B is None else B
    if B is None:
        raise ValueError("shard %dx%d too small for the blocked solver"
                         % (n_l, m_l))
    links = _links_of((pit_src, pit_dst, pit_w), mesh, n_l, m_l,
                      base_s[0].dtype)
    area_s, rounds = _blocked_shards(base_s, W_s, mesh, B, inner_max,
                                     max_rounds, links=links)
    return ShardedCanvas(area_s, mesh), rounds


def _padded_shards(base, W, mesh, q):
    """``base`` and ``W`` as the shards of their (n, m) canvas zero-padded
    to a multiple of ``q`` times the mesh's shape: split so from whole
    canvases; a :class:`ShardedCanvas`'s own shards, its padding zeroed
    (the re-cut of :func:`_solve_shards` takes them onto whole blocks where
    they are not).  Returns ``(base shards, W shards, padded columns)``."""
    n, m = base.shape[-2:]
    if isinstance(base, ShardedCanvas):
        for c in (base, W):
            _check_on(c, mesh)
        if not isinstance(W, ShardedCanvas) or W.shape[-2:] != (n, m) \
                or W.padded_shape[-2:] != base.padded_shape[-2:]:
            raise ValueError("base and W must be laid out alike")
        return base.filled(0.0), W.filled(0.0), base.padded_shape[-1]
    gy, gx = mesh.shape
    shape = (n + (-n) % (q * gy), m + (-m) % (q * gx))
    return (_split(base, mesh, shape=shape), _split(W, mesh, shape=shape),
            shape[1])


def sharded_uca(base, W, mesh, pit_links=None, uca_solver="blocked", B=None):
    """The UCA fixed point over ``mesh`` from unpadded ``base`` (n, m) and
    ``W`` (8, n, m): whole canvases (on any device or the host), which the
    mesh need not divide, or :class:`ShardedCanvas`es of that logical
    shape.  The canvas is zero-padded to a multiple of the mesh (and, for
    ``"blocked"``, of ``B`` on every shard; ``B`` defaults to the JAX
    function's rule on the shard, :func:`_block_size` of ``(n // gy,
    m // gx)``: 256, or 128 for shards under 256) — exact, since pad pixels
    carry no base area and no weight.
    ``pit_links``: optional ``(src, dst, w)`` flat indices into the
    unpadded canvas.  ``"jacobi"``: sharded sweeps, equal to
    ``core.uca.accumulate`` bit for bit.  Returns ``(area, rounds)``, the
    area a ``ShardedCanvas`` of shape (n, m) in the padded shards."""
    _check_solver(uca_solver)
    n, m = base.shape[-2:]
    if uca_solver == "blocked" and B is None:
        gy, gx = mesh.shape
        B = _block_size(n // gy, m // gx)
    base_s, W_s, mp_ = _padded_shards(base, W, mesh, B or 1)
    if pit_links is not None and len(pit_links[0]):
        src, dst, w = (torch.as_tensor(v) for v in pit_links)
        # flat indices into the padded canvas
        pit_links = ((src // m) * mp_ + src % m, (dst // m) * mp_ + dst % m,
                     w)
    else:
        pit_links = None
    area_s, rounds = _solve_shards(base_s, W_s, mesh, pit_links, uca_solver,
                                   B)
    return ShardedCanvas(area_s, mesh, (n, m)), rounds


def _post_shards(area_s, flats_s, mag_s, base):
    """uca and twi per shard, with the smallest base area of the canvas
    ``base`` (a :class:`ShardedCanvas`) over the mesh."""
    min_area = _min_area(base)
    uca_s = [finalize_uca(a, f) for a, f in zip(area_s, flats_s)]
    twi_s = [twi_fn(u, mg, min_area.to(u.device))
             for u, mg in zip(uca_s, mag_s)]
    return uca_s, twi_s


def _row_vectors(n, dt, device, dX, dY, dX2, dY2):
    def vec(a, k, default):
        if a is None:
            return torch.full((k,), default, dtype=dt, device=device)
        return torch.as_tensor(a, dtype=dt).to(device).expand(k).clone()

    return (vec(dX, n - 1, 1.0), vec(dY, n - 1, 1.0), vec(dX2, n, 1.0),
            vec(dY2, n, 1.0))


def _extend_rows(v, k):
    """``v`` with its last value repeated ``k`` more times."""
    return torch.cat([v, v[-1:].expand(k)]) if k else v


class ShardedPipeline:
    """The manager's pipeline over a mesh, split where ``DEMProcessor``
    splits it for the host pit search: :meth:`pre` runs the stencil stages
    per shard and hands the host ``mag``, ``direction`` and ``flats``;
    :meth:`uca` then solves the accumulation fixed point over the mesh with
    the host's pit links.  The engine behind
    ``ProcessManager(mesh=...).process_aspect_slope`` / ``process_uca``.
    The mesh must divide the canvas; the elevation (a host array or a
    tensor) is copied to the cells shard by shard, and the host arrays are
    filled shard by shard (:meth:`ShardedCanvas.numpy`)."""

    def __init__(self, elev, dX, dY, dX2, dY2, mesh, uca_solver="blocked"):
        _check_solver(uca_solver)
        self.mesh = mesh
        self.uca_solver = uca_solver
        dev = mesh.devices[mesh.local_shards()[0]]
        self.dtype = default_dtype(dev)
        if isinstance(elev, torch.Tensor):
            elev = elev.to(self.dtype)
        else:
            elev = torch.as_tensor(np.asarray(elev), dtype=self.dtype)
        shard_dims(elev.shape, mesh)
        self.shape = tuple(elev.shape)
        self.elev_s = _split(elev, mesh)
        self.args = _row_vectors(elev.shape[0], self.dtype, dev, dX, dY, dX2,
                                 dY2)
        self._pre = None
        self.uca_rounds = -1

    def _canvas(self, shards):
        return ShardedCanvas(shards, self.mesh)

    def pre(self):
        """Slope/direction/flats over the mesh; returns host arrays."""
        self._pre = _pre_shards(self.elev_s, *self.args, self.mesh)
        self.min_area = float(_min_area(self._canvas(self._pre["base"])))
        return tuple(self._canvas(self._pre[k]).numpy()
                     for k in ("mag", "direction", "flats"))

    def uca(self, pit_links=None):
        """The accumulation fixed point; returns ``(host area, rounds)``."""
        if self._pre is None:
            self.pre()
        area_s, rounds = _solve_shards(self._pre["base"], self._pre["W"],
                                       self.mesh, pit_links, self.uca_solver)
        self.uca_rounds = int(rounds)
        return self._canvas(area_s).numpy(), self.uca_rounds

    def halo_metrics(self, measure=False):
        """The per-round ring geometry of the decomposition (pixels and
        bytes a shard receives, and their share of the canvas), and with
        ``measure`` the timed overlap of :func:`measure_halo_overlap`."""
        n, m = self.shape
        gy, gx = self.mesh.shape
        n_l, m_l = n // gy, m // gx
        ring = 2 * (n_l + 2) + 2 * m_l  # rows, then extended columns
        out = {"halo_px_per_round_per_shard": ring,
               "halo_bytes_per_round_per_shard":
                   ring * torch.finfo(self.dtype).bits // 8,
               "halo_geometry_fraction": ring * gy * gx / float(n * m),
               "mesh_shape": [int(gy), int(gx)],
               "uca_rounds": self.uca_rounds}
        if measure and self._pre is not None:
            out.update(measure_halo_overlap(self._canvas(self._pre["base"]),
                                            self._canvas(self._pre["W"]),
                                            self.mesh))
        return out


def measure_halo_overlap(base, W, mesh, rounds=8, B=None):
    """Time the halo/compute overlap of the sharded K1 round on this mesh.

    Three fixed-round runs from the same start, every block visited in
    every round: halo exchange only, relaxation only, and the production
    round (the split round where :func:`accumulate_sharded` would use it,
    else the serial one).  ``overlap_fraction = (t_exchange + t_relax -
    t_full) / min(t_exchange, t_relax)``: the share of the cheaper phase
    hidden behind the other (None when that phase is under 5% of the full
    round: noise over noise).  Timed (``"timer"``) with CUDA events when
    every shard is on one GPU, with the host clock around a synchronise of
    every card when the shards are on several (a card's events time only
    its own streams), and with the host clock on the CPU; best of 3 after a
    warm-up.  ``"one_card"``: every shard was on one GPU, so the exchange is
    a copy on that card, not a link between cards; ``"cards"``: the
    distinct devices.  ``base``, ``W``: as :func:`sharded_uca` takes them
    (the canvas zero-padded to whole blocks a shard)."""
    from ..ops.uca_block import compact_from_dense

    n, m = base.shape[-2:]
    if B is None:  # the JAX function's rule
        gy, gx = mesh.shape
        B = _shard_block_size(n // gy, m // gx) or 128
    base_s, W_s, _mp = _padded_shards(base, W, mesh, B)
    if base_s[0].shape[0] % B or base_s[0].shape[1] % B:
        base_s, KW, _src, _dst = _recut_blocked(base_s, W_s, mesh, B)
    else:
        KW = [compact_from_dense(w) for w in W_s]
    del W_s
    base_s = [b.contiguous() for b in base_s]
    nb = (base_s[0].shape[0] // B, base_s[0].shape[1] // B)
    st = _ShardRounds(mesh, base_s, [k for k, _ in KW], [w for _, w in KW],
                      B, 2 * B + 4, _use_split(mesh, nb))
    x0 = [x.clone() for x in st.x]
    events = _one_card(mesh)
    dev = mesh.devices.flat[0]
    cards = [d for d, _ks in mesh.devices_of()]

    def sync():
        if mesh.device_type == "cuda":
            for d in cards:
                torch.cuda.synchronize(d)

    def run(mode):
        for a, b in zip(st.x, x0):
            a.copy_(b)
        if events:
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            t0.record(torch.cuda.current_stream(dev))
        else:
            sync()
            t = time.perf_counter()
        for r in range(rounds):
            st.round(base_s, r % 4, mode)
        if events:
            t1.record(torch.cuda.current_stream(dev))
            t1.synchronize()
            return t0.elapsed_time(t1) / 1e3
        sync()
        return time.perf_counter() - t

    out = {}
    for mode in ("exchange", "relax", "full"):
        run(mode)  # warm-up
        out["t_%s_per_round" % mode] = min(run(mode) for _ in range(3)) \
            / rounds
    te, tr, tf = (out["t_exchange_per_round"], out["t_relax_per_round"],
                  out["t_full_per_round"])
    denom = min(te, tr)
    out["overlap_fraction"] = (None if denom < 0.05 * tf
                               else max(0.0, min(1.0, (te + tr - tf) / denom)))
    out.update(overlap_rounds_timed=rounds, split_round=st.split,
               timer="cuda events" if events else (
                   "host clock, every card synchronised"
                   if mesh.device_type == "cuda" else "host clock"),
               one_card=_one_card(mesh), cards=len(cards), block_size=B,
               device=str(dev))
    return out


def run_sharded(elev, dX, dY, dX2=None, dY2=None, mesh=None, n_sweeps=None,
                uca_solver="jacobi"):
    """The terrain step over ``mesh`` (default: :func:`make_mesh`, every
    visible GPU).  ``elev``: a whole canvas (a numpy array or a tensor on
    any device, its dtype kept), copied to the cells shard by shard, or a
    :class:`ShardedCanvas` over ``mesh``, built shard by shard on the
    cells.  A canvas the mesh does not divide is extended with NaN
    (no-data) rows and columns — the padded canvas is then the computed
    domain, as in the JAX version — and the outputs are cropped to it.

    ``n_sweeps``: that many Jacobi sweeps; else ``uca_solver``: ``"jacobi"``
    (sweeps over the shards to the fixed point) or ``"blocked"`` (the
    sharded K1 solver, :func:`accumulate_sharded`).
    Returns the dict of :func:`terrain_step`, its canvases
    ``ShardedCanvas``es left on their shards (as the JAX version leaves
    them sharded; ``.assemble()`` or ``np.asarray`` for a whole one): equal
    to ``terrain_step`` on the same (padded) canvas bit for bit, apart from
    the blocked solver's ``uca_sweeps`` (the rounds of the mesh's shape)."""
    if mesh is None:
        mesh = make_mesh()
    _check_solver(uca_solver)
    gy, gx = mesh.shape
    if isinstance(elev, ShardedCanvas):
        _check_on(elev, mesh)
        n_, m_ = elev.shape
        n = elev.padded_shape[0]
        elev_s = elev.filled(float("nan"))
    else:
        if not isinstance(elev, torch.Tensor):
            elev = torch.as_tensor(np.asarray(elev))
        n_, m_ = elev.shape
        n = n_ + (-n_) % gy
        elev_s = _split(elev, mesh, shape=(n, m_ + (-m_) % gx),
                        pad=float("nan"))
    dev = mesh.devices[mesh.local_shards()[0]]
    dX, dY, dX2, dY2 = (_extend_rows(v, n - n_) for v in _row_vectors(
        n_, elev_s[0].dtype, dev, dX, dY, dX2, dY2))
    pre = _pre_shards(elev_s, dX, dY, dX2, dY2, mesh)
    del elev_s
    W_s = pre.pop("W")
    if n_sweeps is not None:
        area_s, rounds = _jacobi_shards(pre["base"], W_s, mesh,
                                        n_sweeps=n_sweeps)
    else:
        # the JAX run_sharded's B, the shard rule (where a shard has none,
        # which the JAX function refuses, one device's, re-cut)
        area_s, rounds = _solve_shards(
            pre["base"], W_s, mesh, uca_solver=uca_solver,
            B=_shard_block_size(*pre["base"][0].shape))
    del W_s
    uca_s, twi_s = _post_shards(area_s, pre["flats"], pre["mag"],
                                ShardedCanvas(pre["base"], mesh, (n_, m_)))
    out = {k: ShardedCanvas(v, mesh, (n_, m_))
           for k, v in (("mag", pre["mag"]), ("direction", pre["direction"]),
                        ("flats", pre["flats"]), ("uca", uca_s),
                        ("twi", twi_s))}
    out["uca_sweeps"] = int(rounds)
    return out
