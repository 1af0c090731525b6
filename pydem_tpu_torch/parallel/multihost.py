"""Several processes, one shard each: the ``torch.distributed`` back end.

Port of ``pydem_tpu/parallel/multihost.py``.  The JAX version lets
``jax.distributed`` coordinate the processes and GSPMD lay the canvas over
the global mesh.  Here each rank of the default process group owns one
shard of a :class:`~pydem_tpu_torch.parallel.mesh.Mesh` made with
``distributed=True``, and :class:`DistExchange` is the mesh's exchange: the
1-px rings travel by point-to-point sends (rows, then whole columns, as the
in-process back end copies them) and the convergence sum by ``all_reduce``.
The sharded solvers of :mod:`.sharded` run on it unchanged.  A run is:

    multihost.initialize("tcp://host:port", num_processes, process_id)
    out = multihost.run_global(this_ranks_row_band, dX, dY, dX2, dY2)

Gloo carries it on CPU tensors; NCCL on GPUs, one rank per card:
``initialize(..., backend="nccl")`` makes the rank's card (``LOCAL_RANK``,
or the rank modulo the visible cards) the current device before the group
comes up, so each rank's communicator and tensors are on its own card, and
the rings travel as batched point-to-point pairs (``batch_isend_irecv``),
which NCCL runs as one group and which cannot deadlock on two ranks sending
first.  NCCL takes no two ranks on one card.
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend="gloo"):
    """Join the default process group (no-op for one process or when it is
    already up).  ``coordinator_address``: ``host:port`` of rank 0 (or any
    ``init_method`` URL); ``backend``: ``"gloo"`` (CPU tensors) or
    ``"nccl"`` (one rank per card: the rank's card becomes the current
    device first).  The group is torn down at exit, as
    ``jax.distributed`` shuts down, so no rank exits with the back end's
    threads alive."""
    if num_processes in (None, 1) or dist.is_initialized():
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    url = coordinator_address
    if url is not None and "://" not in url:
        url = "tcp://" + url
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    atexit.register(shutdown)


def shutdown():
    """Leave the default process group (no-op when it is not up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(shape=None, device=None):
    """The mesh of every rank, one shard each, rank ``iy * gx + ix``:
    ``(world, 1)`` row bands by default, so each process owns contiguous
    canvas rows.  ``device``: this rank's device (default: the CPU under
    gloo, the current card under NCCL, which :func:`initialize` set).  Each
    rank's mesh names its own device in every cell: a rank reads only its
    own cell's."""
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(shape)
    if shape[0] * shape[1] != world:
        raise ValueError("a %dx%d mesh needs %d ranks, the group has %d"
                         % (shape + (shape[0] * shape[1], world)))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh([torch.device(device)] * world, shape, distributed=True)


class DistExchange:
    """Back end (b): this rank's shard; its neighbours are other ranks."""

    def __init__(self, mesh):
        if not mesh.distributed:
            raise ValueError("DistExchange needs a mesh with "
                             "distributed=True")
        gy, gx = mesh.shape
        if dist.get_world_size() != gy * gx:
            raise ValueError("a %dx%d mesh over %d ranks"
                             % (gy, gx, dist.get_world_size()))
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.iy, self.ix = divmod(self.rank, gx)

    def _trade(self, pairs):
        """``pairs``: (peer rank, tensor to send, tensor to receive into).
        All sends and receives are posted as one batch, then waited for."""
        if not pairs:
            return
        ops, bufs = [], []
        for peer, send, recv in pairs:
            buf = torch.empty(recv.shape, dtype=recv.dtype,
                              device=recv.device)
            ops.append(dist.P2POp(dist.isend, send.contiguous(), peer))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            bufs.append((recv, buf))
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        for recv, buf in bufs:
            recv.copy_(buf)

    def halo(self, planes, depth=1):
        """As :meth:`LocalExchange.halo`, for this rank's one plane."""
        gy, gx = self.mesh.shape
        d = depth
        p = planes[0]
        n_l, m_l = p.shape[-2] - 2 * d, p.shape[-1] - 2 * d
        up, down = self.rank - gx, self.rank + gx
        rows = []
        if self.iy > 0:
            rows.append((up, p[..., d:2 * d, d:d + m_l],
                         p[..., :d, d:d + m_l]))
        if self.iy < gy - 1:
            rows.append((down, p[..., n_l: n_l + d, d:d + m_l],
                         p[..., n_l + d:, d:d + m_l]))
        self._trade(rows)
        cols = []
        if self.ix > 0:
            cols.append((self.rank - 1, p[..., :, d:2 * d], p[..., :, :d]))
        if self.ix < gx - 1:
            cols.append((self.rank + 1, p[..., :, m_l: m_l + d],
                         p[..., :, m_l + d:]))
        self._trade(cols)
        return planes

    def reduce(self, values, op="sum"):
        """``op`` ("sum", "min" or "max") over this rank's values and every
        other rank's, on this rank's device."""
        dev = self.mesh.devices[self.iy, self.ix]
        v = torch.stack([torch.as_tensor(t).to(dev) for t in values])
        v = {"sum": v.sum, "min": v.amin, "max": v.amax}[op](0)
        dist.all_reduce(v, {"sum": dist.ReduceOp.SUM,
                            "min": dist.ReduceOp.MIN,
                            "max": dist.ReduceOp.MAX}[op])
        return v

    def recut(self, tensors, src, dst, fill):
        """As :meth:`LocalExchange.recut`, for this rank's one tensor: the
        parts of its ``src`` piece that other ranks' ``dst`` pieces cover
        are sent to them, the parts of its ``dst`` piece that other ranks
        hold are received, all as one batch of point-to-point pairs."""
        from .mesh import cut

        me, t = self.rank, tensors[0]
        lead = tuple(t.shape[:-2])
        dev, (d0, e0, dh, dw) = dst[me]
        out = torch.full(lead + (dh, dw), fill, dtype=t.dtype, device=dev)
        r0, c0, h, w = src[me][1]
        ops, recvs = [], []
        for peer, (_d, piece) in enumerate(dst):
            c = cut(((r0, r0 + h), (c0, c0 + w)), piece)
            if c is None:
                continue
            part = t[(Ellipsis,) + c[0]]
            if peer == me:
                out[(Ellipsis,) + c[1]].copy_(part)
            else:
                ops.append(dist.P2POp(dist.isend, part.contiguous(), peer))
        for peer, (_d, (s0, t0, sh, sw)) in enumerate(src):
            c = cut(((s0, s0 + sh), (t0, t0 + sw)), (d0, e0, dh, dw))
            if peer == me or c is None:
                continue
            to = c[1]
            buf = torch.empty(lead + (to[0].stop - to[0].start,
                                      to[1].stop - to[1].start),
                              dtype=t.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            recvs.append((to, buf))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        for to, buf in recvs:
            out[(Ellipsis,) + to].copy_(buf)
        return [out]

    def sum_(self, t):
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, dist.ReduceOp.SUM)
        return t

    def gather(self, shard, device=None):
        """The whole canvas from every rank's shard, on every rank (what
        :meth:`ShardedCanvas.assemble` runs on a distributed mesh)."""
        gy, gx = self.mesh.shape
        kind = shard.dtype
        if kind == torch.bool:  # sent as bytes
            shard = shard.to(torch.uint8)
        parts = [torch.empty_like(shard) for _ in range(gy * gx)]
        dist.all_gather(parts, shard.contiguous())
        rows = [torch.cat(parts[iy * gx: (iy + 1) * gx], dim=-1)
                for iy in range(gy)]
        out = torch.cat(rows, dim=-2).to(kind)
        return out if device is None else out.to(device)


def assemble_global(local_rows, mesh):
    """This rank's shard from its row band of the canvas (equal heights on
    every rank, a ``(world, 1)`` mesh): the tensor on this rank's
    device."""
    gy, gx = mesh.shape
    if gx != 1:
        raise ValueError("row bands need a (world, 1) mesh, got %dx%d"
                         % (gy, gx))
    dev = mesh.devices.flat[dist.get_rank()]
    return torch.as_tensor(local_rows).to(dev)


def run_global(local_rows, dX, dY, dX2=None, dY2=None, mesh=None,
               n_sweeps=None, uca_solver="jacobi"):
    """The terrain step over the ranks: each passes its row band and the
    whole canvas's row vectors (``dX``/``dY`` n-1, ``dX2``/``dY2`` n).
    ``uca_solver="blocked"`` runs the sharded K1 solver with the rings sent
    between ranks; the per-round change count is the one ``all_reduce``
    that every rank joins.  Returns the dict of
    :func:`~pydem_tpu_torch.parallel.sharded.run_sharded` with sharded
    outputs, as the JAX version returns them: each canvas a
    :class:`~pydem_tpu_torch.parallel.mesh.ShardedCanvas` whose
    ``local_shards()`` is this rank's band.  Slice out your own rows for
    export, or gather the whole canvas with ``.assemble()`` (a collective
    that every rank joins)."""
    from . import sharded
    from .mesh import ShardedCanvas

    if mesh is None:
        mesh = global_mesh()
    sharded._check_solver(uca_solver)
    shard = assemble_global(local_rows, mesh)
    n = shard.shape[0] * mesh.shape[0]
    dev, dt = shard.device, shard.dtype
    args = sharded._row_vectors(n, dt, dev, dX, dY, dX2, dY2)
    pre = sharded._pre_shards([shard], *args, mesh)
    del shard
    W_s = pre.pop("W")
    if n_sweeps is not None:
        area_s, rounds = sharded._jacobi_shards(pre["base"], W_s, mesh,
                                                n_sweeps=n_sweeps)
    else:
        area_s, rounds = sharded._solve_shards(pre["base"], W_s, mesh,
                                               uca_solver=uca_solver)
    del W_s
    uca_s, twi_s = sharded._post_shards(area_s, pre["flats"], pre["mag"],
                                        ShardedCanvas(pre["base"], mesh))
    out = {k: ShardedCanvas(v, mesh)
           for k, v in (("mag", pre["mag"]), ("direction", pre["direction"]),
                        ("flats", pre["flats"]), ("uca", uca_s),
                        ("twi", twi_s))}
    out["uca_sweeps"] = int(rounds)
    return out
