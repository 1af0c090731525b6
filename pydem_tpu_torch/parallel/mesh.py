"""Device meshes and the halo exchange of the sharded solver.

The port's counterpart of ``make_mesh``, ``canvas_sharding`` and
``replicated`` in ``pydem_tpu/parallel/sharded.py``.  The JAX package lays
one logical canvas over a ``Mesh('y', 'x')`` of devices and lets
``shard_map``/``ppermute`` move 1-px halo rings and ``psum`` decide
convergence.  Here a canvas over a mesh is a list of *shards*, one tensor
per mesh cell in row-major order, each on its cell's device, and everything
that crosses a shard's edge goes through an *exchange*:

- ``halo(planes, depth)``: ``planes`` holds, for each shard this process
  owns, an array whose last two dimensions are the shard with a ring of
  ``depth`` pixels; the ring is overwritten with the neighbouring shards'
  edge pixels in two phases, rows first and then whole columns (ring rows
  included), so that the corners hop through the y-neighbour, as the JAX
  solver's two ``ppermute`` phases do.  Where the canvas ends there is no
  neighbour and the ring keeps what the caller put there (the JAX
  ``ppermute`` delivers zeros; callers pad with the value they need);
- ``reduce(values, op)``: one value per owned shard in, the sum, minimum
  or maximum over the whole mesh out (the ``psum``).

Two back ends implement it.  :class:`LocalExchange` (here) holds every shard
in this process: a mesh cell is a ``torch.device``, several cells may name
the same device (a 2×2 mesh on one GPU is four shards on ``cuda:0``, as the
JAX tests put eight virtual devices on one CPU) or each its own card (a 2×2
mesh over ``cuda:0..3``), a ring is a slice copy and the reduction a sum of
the per-shard values on the first device.  The ``torch.distributed`` back
end, one shard per rank, is
:class:`pydem_tpu_torch.parallel.multihost.DistExchange`.

Between two cards a ring is a cross-device ``copy_``.  PyTorch runs it on
the source card's current stream behind a two-way barrier with the
destination card's current stream, so it is ordered against the work of
both cards' current streams; a strided (column) ring goes through PyTorch's
peer copy kernel or a contiguous temporary, the same bytes either way.
Callers that move work to other streams make those streams current on each
card around the exchange (the split round of :mod:`.sharded` does).
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Mesh:
    """A 2-D (y, x) grid of devices.

    ``devices``: an object array of ``torch.device`` of shape ``(gy, gx)``,
    as the JAX mesh's ``devices`` (``mesh.devices.shape``, ``mesh.size``
    read the same).  ``distributed``: the cells are the ranks of the
    default ``torch.distributed`` process group, rank ``iy * gx + ix``, and
    this process owns only its own cell.
    """

    def __init__(self, devices, shape, distributed=False):
        gy, gx = (int(v) for v in shape)
        devs = list(devices)
        if len(devs) != gy * gx:
            raise ValueError("a %dx%d mesh needs %d devices, got %d"
                             % (gy, gx, gy * gx, len(devs)))
        arr = np.empty(gy * gx, dtype=object)
        for k, d in enumerate(devs):
            arr[k] = torch.device(d)
        self.devices = arr.reshape(gy, gx)
        self.distributed = bool(distributed)
        types = {d.type for d in arr}
        if len(types) != 1:
            raise ValueError("a mesh's devices must be of one type, got %s"
                             % sorted(types))
        self._exchange = None

    @property
    def shape(self):
        return self.devices.shape

    @property
    def size(self):
        return self.devices.size

    @property
    def device_type(self):
        return self.devices.flat[0].type

    @property
    def distinct_devices(self):
        """The number of different devices the cells name."""
        return len(set(self.devices.flat))

    def devices_of(self):
        """The distinct devices of this process's shards, in order of first
        appearance, each with the positions (in :meth:`local_shards` order)
        of the shards it holds: ``[(device, [k, ...]), ...]``."""
        out = {}
        for k, cell in enumerate(self.local_shards()):
            out.setdefault(self.devices[cell], []).append(k)
        return list(out.items())

    def local_shards(self):
        """The (iy, ix) cells this process owns, in row-major order."""
        gy, gx = self.shape
        if self.distributed:
            import torch.distributed as dist

            return [divmod(dist.get_rank(), gx)]
        return [(iy, ix) for iy in range(gy) for ix in range(gx)]

    def exchange(self):
        """The mesh's exchange (created once)."""
        if self._exchange is None:
            if self.distributed:
                from .multihost import DistExchange

                self._exchange = DistExchange(self)
            else:
                self._exchange = LocalExchange(self)
        return self._exchange

    def __repr__(self):
        return "Mesh(%dx%d, %s%s)" % (self.shape + (
            sorted({str(d) for d in self.devices.flat}),
            ", distributed" if self.distributed else ""))


def make_mesh(devices=None, shape=None):
    """A (y, x) mesh.  ``devices`` defaults to every visible CUDA device
    (an error without one: the CPU is used only when its devices are
    given, e.g. ``make_mesh([torch.device("cpu")] * 4, (2, 2))``); ``shape``
    to the most-square factorization of their number, rows ≤ columns."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch.cuda is not available; pass "
                               "the devices (e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        a = int(math.sqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    return Mesh(devices[: shape[0] * shape[1]], shape)


def check_mesh(mesh, device):
    """``mesh`` is None or a :class:`Mesh` whose devices are of
    ``device``'s type (the entry points' ``mesh=`` argument)."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a pydem_tpu_torch.parallel.mesh.Mesh "
                        "(make_mesh), got %r" % (type(mesh).__name__,))
    if mesh.device_type != torch.device(device).type:
        raise ValueError("the mesh's devices are %s but device is %s"
                         % (mesh.device_type, device))


def shard_dims(shape, mesh):
    """(n_l, m_l) of each shard of an (n, m) canvas; the mesh must divide
    it."""
    n, m = shape[-2:]
    gy, gx = mesh.shape
    if n % gy or m % gx:
        raise ValueError("a %dx%d canvas does not divide over a %dx%d mesh"
                         % (n, m, gy, gx))
    return n // gy, m // gx


def split(canvas, mesh, ring=0, fill=0):
    """The shards this process owns of ``canvas`` (``(..., n, m)``), each a
    contiguous copy on its cell's device; with ``ring`` > 0 each comes
    inside a ring of that many pixels set to ``fill``, for
    :meth:`LocalExchange.halo` to overwrite."""
    n_l, m_l = shard_dims(canvas.shape, mesh)
    out = []
    for iy, ix in mesh.local_shards():
        s = canvas[..., iy * n_l: (iy + 1) * n_l, ix * m_l: (ix + 1) * m_l]
        s = s.to(mesh.devices[iy, ix])
        if ring:
            s = torch.nn.functional.pad(s, (ring,) * 4, value=fill)
        out.append(s.contiguous())
    return out


def assemble(shards, mesh, ring=0, device=None):
    """The canvas whose shards are ``shards`` (their rings of ``ring`` px
    dropped), on ``device`` (default: the first cell's).  Over the
    distributed back end every rank receives the whole canvas."""
    if ring:
        shards = [s[..., ring: s.shape[-2] - ring, ring: s.shape[-1] - ring]
                  for s in shards]
    if mesh.distributed:
        return mesh.exchange().gather(shards[0], device)
    gy, gx = mesh.shape
    device = mesh.devices.flat[0] if device is None else device
    rows = [torch.cat([shards[iy * gx + ix].to(device) for ix in range(gx)],
                      dim=-1) for iy in range(gy)]
    return torch.cat(rows, dim=-2)


class LocalExchange:
    """Back end (a): every shard of the mesh lives in this process."""

    def __init__(self, mesh):
        if mesh.distributed:
            raise ValueError("LocalExchange needs a mesh without "
                             "distributed=True")
        self.mesh = mesh
        self.shards = mesh.local_shards()

    def _index(self, iy, ix):
        return iy * self.mesh.shape[1] + ix

    def halo(self, planes, depth=1):
        """Fill the ``depth``-px rings of ``planes`` (one per shard,
        ``(..., n_l + 2d, m_l + 2d)``) from the neighbouring shards: rows,
        then extended columns.  In place; returns ``planes``."""
        gy, gx = self.mesh.shape
        d = depth
        n_l, m_l = planes[0].shape[-2] - 2 * d, planes[0].shape[-1] - 2 * d
        if n_l < d or m_l < d:
            raise ValueError("a %dx%d shard is too small for a %d-px ring"
                             % (n_l, m_l, d))
        for iy, ix in self.shards:  # phase 1: rows
            p = planes[self._index(iy, ix)]
            if iy > 0:
                up = planes[self._index(iy - 1, ix)]
                p[..., :d, d:d + m_l].copy_(up[..., n_l: n_l + d, d:d + m_l])
            if iy < gy - 1:
                dn = planes[self._index(iy + 1, ix)]
                p[..., n_l + d:, d:d + m_l].copy_(dn[..., d:2 * d, d:d + m_l])
        for iy, ix in self.shards:  # phase 2: columns, ring rows included
            p = planes[self._index(iy, ix)]
            if ix > 0:
                lt = planes[self._index(iy, ix - 1)]
                p[..., :, :d].copy_(lt[..., :, m_l: m_l + d])
            if ix < gx - 1:
                rt = planes[self._index(iy, ix + 1)]
                p[..., :, m_l + d:].copy_(rt[..., :, d:2 * d])
        return planes

    def reduce(self, values, op="sum"):
        """``op`` ("sum", "min" or "max") over one value (tensor) per shard,
        on the first cell's device (a value on another card is copied after
        the work its card's current stream holds)."""
        dev = self.mesh.devices.flat[0]
        v = torch.stack([torch.as_tensor(t).to(dev) for t in values])
        return {"sum": v.sum, "min": v.amin, "max": v.amax}[op](0)
