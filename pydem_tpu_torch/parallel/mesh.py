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
  or maximum over the whole mesh out (the ``psum``);
- ``recut(tensors, src, dst, fill)``: the owned shards of a canvas laid out
  as ``src`` cut anew to the layout ``dst`` (:func:`layout`), e.g. onto
  shards that are whole K1 blocks.

The mesh functions return their canvases as a :class:`ShardedCanvas`: the
shards, each on its cell's device, with the logical shape, as the JAX
functions return arrays laid over the mesh; a caller assembles only when
it asks for the whole canvas.

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


def split(canvas, mesh, ring=0, fill=0, shape=None, pad=0):
    """The shards this process owns of ``canvas`` (``(..., n, m)``: a
    tensor on any device, or a host array), each a contiguous copy on its
    cell's device, copied there shard by shard (no device stages the
    whole canvas).  ``shape``: the (rows, columns) the mesh divides, at
    least the canvas's own (default); pixels beyond the canvas are ``pad``.
    With ``ring`` > 0 each shard comes inside a ring of that many pixels
    set to ``fill``, for :meth:`LocalExchange.halo` to overwrite."""
    if not isinstance(canvas, torch.Tensor):
        canvas = torch.as_tensor(np.asarray(canvas))
    n, m = canvas.shape[-2:]
    shape = (n, m) if shape is None else tuple(shape)
    if shape[0] < n or shape[1] < m:
        raise ValueError("a %dx%d canvas does not fit %dx%d"
                         % ((n, m) + shape))
    n_l, m_l = shard_dims(shape, mesh)
    lead = tuple(canvas.shape[:-2])
    out = []
    for iy, ix in mesh.local_shards():
        r0, c0 = iy * n_l, ix * m_l
        s = canvas[..., r0: r0 + n_l, c0: c0 + m_l]
        dev = mesh.devices[iy, ix]
        if tuple(s.shape[-2:]) == (n_l, m_l):
            s = s.to(dev)
        else:
            t = torch.full(lead + (n_l, m_l), pad, dtype=s.dtype, device=dev)
            t[..., : s.shape[-2], : s.shape[-1]].copy_(s)
            s = t
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


# -- re-cutting a canvas between two layouts of pieces ----------------------

def layout(mesh, shape):
    """Where the shards of an (n, m) canvas (``shape``'s last two; the mesh
    must divide them) lie: ``[(device, (row0, col0, h, w)), ...]`` for every
    cell of the mesh, row-major."""
    n_l, m_l = shard_dims(shape, mesh)
    gy, gx = mesh.shape
    return [(mesh.devices[iy, ix], (iy * n_l, ix * m_l, n_l, m_l))
            for iy in range(gy) for ix in range(gx)]


def pieces(mesh, shape):
    """:func:`layout` of the cells this process owns, in
    :meth:`Mesh.local_shards` order."""
    cells, gx = layout(mesh, shape), mesh.shape[1]
    return [cells[iy * gx + ix] for iy, ix in mesh.local_shards()]


def cut(block, piece):
    """Where a window ``((i0, i1), (j0, j1))`` of the canvas and a piece
    ``(row0, col0, h, w)`` of it overlap: the slices into the window and
    into the piece, or None."""
    (i0, i1), (j0, j1) = block
    r0, c0, h, w = piece
    a0, a1 = max(i0, r0), min(i1, r0 + h)
    b0, b1 = max(j0, c0), min(j1, c0 + w)
    if a0 >= a1 or b0 >= b1:
        return None
    return ((slice(a0 - i0, a1 - i0), slice(b0 - j0, b1 - j0)),
            (slice(a0 - r0, a1 - r0), slice(b0 - c0, b1 - c0)))


def _window_of(piece):
    r0, c0, h, w = piece
    return (r0, r0 + h), (c0, c0 + w)


def retile(tensors, src, dst, fill):
    """A canvas held in this process as ``tensors`` (``(..., h, w)``) on the
    pieces ``src`` (``[(device, (row0, col0, h, w)), ...]``) cut anew to the
    pieces ``dst``, each on its device; ``fill`` where no source piece
    reaches."""
    lead = tuple(tensors[0].shape[:-2])
    out = []
    for dev, piece in dst:
        t = torch.full(lead + tuple(piece[2:]), fill,
                       dtype=tensors[0].dtype, device=dev)
        for a, (_dev, sp) in zip(tensors, src):
            c = cut(_window_of(sp), piece)
            if c is not None:
                t[(Ellipsis,) + c[1]].copy_(a[(Ellipsis,) + c[0]])
        out.append(t)
    return out


def same_mesh(a, b):
    """Whether two meshes name the same devices in the same cells."""
    return a is b or (a.shape == b.shape and a.distributed == b.distributed
                      and all(x == y for x, y in zip(a.devices.flat,
                                                     b.devices.flat)))


class ShardedCanvas:
    """A canvas laid over a mesh, one shard a cell, each on its cell's
    device: the port's counterpart of a ``jax.Array`` under
    ``NamedSharding(mesh, P("y", "x"))``, which the JAX mesh functions
    return.

    ``shards``: one tensor ``(..., n_l, m_l)`` for each cell this process
    owns, in :meth:`Mesh.local_shards` order (every cell in one process;
    this rank's alone on a ``distributed=True`` mesh).  ``shape``: the
    logical canvas, at most the shards' padded one (default): a canvas
    padded to the mesh keeps its padded shards and is cropped in
    ``shape``, as the JAX ``v[:n, :m]``.

    Nothing here moves the whole canvas to one device unless asked:
    :meth:`assemble` does (a collective on a distributed mesh);
    :meth:`numpy` copies each shard into its slice of one host array;
    :meth:`window` gathers a window of the canvas from the shards that
    cover it.  ``np.asarray(canvas)`` is :meth:`numpy`.
    """

    def __init__(self, shards, mesh, shape=None):
        shards = list(shards)
        cells = mesh.local_shards()
        if len(shards) != len(cells):
            raise ValueError("%d shards for the %d cells of %r this process "
                             "owns" % (len(shards), len(cells), mesh))
        first = tuple(shards[0].shape)
        for s, cell in zip(shards, cells):
            if tuple(s.shape) != first:
                raise ValueError("shards of shapes %s and %s"
                                 % (first, tuple(s.shape)))
            want = mesh.devices[cell]
            if s.device.type != want.type or (
                    want.index is not None and s.device.index != want.index):
                raise ValueError("shard %s is on %s, its cell on %s"
                                 % (cell, s.device, want))
        gy, gx = mesh.shape
        self.padded_shape = first[:-2] + (first[-2] * gy, first[-1] * gx)
        shape = self.padded_shape if shape is None else tuple(
            int(v) for v in shape)
        if len(shape) != len(first) or shape[:-2] != first[:-2] or any(
                a > b for a, b in zip(shape[-2:], self.padded_shape[-2:])):
            raise ValueError("a %s canvas in shards of a %s one"
                             % (shape, self.padded_shape))
        self.mesh, self.shape, self._shards = mesh, shape, shards

    @property
    def dtype(self):
        return self._shards[0].dtype

    def local_shards(self):
        """This process's shards, in :meth:`Mesh.local_shards` order (on a
        distributed mesh: this rank's one)."""
        return list(self._shards)

    def shard(self, iy, ix):
        """The shard of cell (iy, ix), padding included; a cell of another
        rank is an error."""
        cells = self.mesh.local_shards()
        if (iy, ix) not in cells:
            raise ValueError("cell (%d, %d) is not held by this process"
                             % (iy, ix))
        return self._shards[cells.index((iy, ix))]

    def pieces(self):
        """Where this process's shards lie in the padded canvas
        (:func:`pieces`)."""
        return pieces(self.mesh, self.padded_shape)

    def views(self):
        """Each local shard cropped to the logical canvas, with where it
        lies: ``[(view, (row0, col0, h, w)), ...]`` (``h`` or ``w`` 0 for a
        shard wholly in the padding)."""
        n, m = self.shape[-2:]
        out = []
        for s, (_dev, (r0, c0, h, w)) in zip(self._shards, self.pieces()):
            h, w = max(0, min(h, n - r0)), max(0, min(w, m - c0))
            out.append((s[..., :h, :w], (r0, c0, h, w)))
        return out

    def filled(self, value):
        """The local shards with every pixel beyond ``shape`` set to
        ``value`` (new tensors for the shards that reach past it, the
        shards themselves otherwise)."""
        out = []
        for s, (view, _piece) in zip(self._shards, self.views()):
            if view.shape != s.shape:
                h, w = view.shape[-2:]
                s = s.clone()
                s[..., h:, :] = value
                s[..., :, w:] = value
            out.append(s)
        return out

    def window(self, rows, cols, device=None):
        """Rows ``rows[0]:rows[1]`` and columns ``cols[0]:cols[1]`` of the
        canvas, gathered from the local shards that cover them onto
        ``device`` (default: the first of those shards' device)."""
        (i0, i1), (j0, j1) = rows, cols
        n, m = self.shape[-2:]
        if not (0 <= i0 < i1 <= n and 0 <= j0 < j1 <= m):
            raise ValueError("window %s x %s outside a %dx%d canvas"
                             % (rows, cols, n, m))
        parts = [(s, c) for s, (_d, p) in zip(self._shards, self.pieces())
                 for c in [cut((rows, cols), p)] if c is not None]
        covered = sum((c[0][0].stop - c[0][0].start)
                      * (c[0][1].stop - c[0][1].start) for _s, c in parts)
        if covered != (i1 - i0) * (j1 - j0):
            raise ValueError("window %s x %s reaches shards of other ranks"
                             % (rows, cols))
        device = parts[0][0].device if device is None else device
        out = torch.empty(self.shape[:-2] + (i1 - i0, j1 - j0),
                          dtype=self.dtype, device=device)
        for s, (to, frm) in parts:
            out[(Ellipsis,) + to].copy_(s[(Ellipsis,) + frm])
        return out

    def assemble(self, device=None):
        """The whole canvas on ``device`` (default: the first cell's).  On a
        distributed mesh a collective: every rank must call it, and each
        receives the whole canvas (on its own device by default)."""
        n, m = self.shape[-2:]
        return assemble(self._shards, self.mesh, device=device)[..., :n, :m]

    def numpy(self):
        """The canvas as one host array, each shard copied into its slice
        (no device holds more than its own shards).  Not on a distributed
        mesh, whose other shards live in other processes: there
        :meth:`assemble` (a collective) or :meth:`local_shards`."""
        if self.mesh.distributed:
            raise ValueError("the canvas spans other ranks: assemble() it "
                             "(a collective) or read local_shards()")
        out = None
        for view, (r0, c0, h, w) in self.views():
            part = view.cpu().numpy()
            if out is None:
                out = np.empty(self.shape, dtype=part.dtype)
            out[..., r0: r0 + h, c0: c0 + w] = part
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __repr__(self):
        return "ShardedCanvas(%s, %s, %r)" % (self.shape, self.dtype,
                                             self.mesh)


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

    def recut(self, tensors, src, dst, fill):
        """The canvas held as ``tensors`` (one per cell) on the layout
        ``src`` cut anew to the layout ``dst`` (:func:`layout`);
        ``fill`` where ``src`` does not reach."""
        return retile(tensors, src, dst, fill)

    def reduce(self, values, op="sum"):
        """``op`` ("sum", "min" or "max") over one value (tensor) per shard,
        on the first cell's device (a value on another card is copied after
        the work its card's current stream holds)."""
        dev = self.mesh.devices.flat[0]
        v = torch.stack([torch.as_tensor(t).to(dev) for t in values])
        return {"sum": v.sum, "min": v.amin, "max": v.amax}[op](0)
