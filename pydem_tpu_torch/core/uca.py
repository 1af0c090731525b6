"""Upstream contributing area (UCA) as a dense stencil fixed point.

Port of ``pydem_tpu/core/uca.py``: on the pruned drainage DAG the area is the
fixed point of ``area = base + Σ_k scatter_k(W_k ⊙ area) + links(area)``,
which Jacobi iteration reaches exactly after (longest flow path + 1)
sweeps; ``links`` are the non-adjacent pit drains (:class:`PitLinks`).
"""
from __future__ import annotations

import torch

from .stencil import NEIGHBOR_OFFSETS, scatter_shift


def base_area(dX2, dY2, shape, dtype=None):
    """Per-pixel self area = dX2·dY2 broadcast along rows (an expanded
    view, not a copy)."""
    n, m = shape
    a = (torch.as_tensor(dX2) * torch.as_tensor(dY2)).reshape(n, 1)
    if dtype is not None:
        a = a.to(dtype)
    return a.expand(n, m)


class PitLinks:
    """Pit links ``src → dst`` with weight ``w`` (flat pixel indices),
    prepared once per solve for a deterministic fold.

    The JAX package folds them with ``out.at[dst].add(x[src] * w)``, which
    XLA applies in link order.  On CUDA an ``index_add_`` with repeated
    destinations is a float atomic whose sum depends on the order the
    threads land in.  Here the links are sorted by destination (stably, so
    each destination keeps the link order), laid out as a (destinations,
    width) table, and each destination's contributions are added one column
    at a time: ``out[d] + c_0 + c_1 + ...``, the order XLA uses, on every
    device and every run.  Each pass costs one small launch; ``width`` is
    the largest number of links into one pixel.
    """

    def __init__(self, src, dst, w):
        dst_sorted, order = torch.sort(dst.long(), stable=True)
        self.src = src.long()[order]
        self.w = w[order]
        self.dst, inverse, counts = torch.unique_consecutive(
            dst_sorted, return_inverse=True, return_counts=True)
        self.width = int(counts.max()) if counts.numel() else 0
        start = torch.cumsum(counts, 0) - counts
        rank = (torch.arange(dst_sorted.numel(), device=dst.device)
                - start[inverse])
        self.slot = inverse * self.width + rank

    def __len__(self):
        return self.src.numel()

    def add_to(self, out, x):
        """``out`` plus the links' inflow from ``x`` (same shape; a new
        tensor)."""
        flat = out.reshape(-1).clone()
        if not len(self):
            return flat.view(out.shape)
        table = x.new_zeros(self.dst.numel() * self.width)
        table[self.slot] = x.reshape(-1)[self.src] * self.w  # unique slots
        table = table.view(-1, self.width)
        acc = flat[self.dst]
        for r in range(self.width):
            acc = acc + table[:, r]
        flat[self.dst] = acc  # unique destinations
        return flat.view(out.shape)


def flow_sweep(x, W, links=None):
    """One application of the accumulation operator: inflow(x) (no base).

    ``links`` (:class:`PitLinks` or None) adds the pit-link inflow after the
    stencil, as the JAX version's ``pit_src``/``pit_dst``/``pit_w`` do.
    """
    out = torch.zeros_like(x)
    for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
        out = out + scatter_shift(W[k] * x, di, dj, 0.0)
    if links is not None:
        out = links.add_to(out, x)
    return out


def accumulate(base, W, pit_src=None, pit_dst=None, pit_w=None,
               max_iters=1_000_000, check_every=4):
    """Solve area = base + A·area by Jacobi sweeps until a fixed point.

    ``pit_src``/``pit_dst``/``pit_w``: optional pit links (flat indices and
    weights).  Runs ``check_every`` sweeps between convergence tests; each
    test is one host sync.  Returns ``(area, n_sweeps)``.
    """
    links = None if pit_src is None else PitLinks(pit_src, pit_dst, pit_w)
    x = base
    prev = torch.full_like(base, -1.0)
    it = 0
    while it < max_iters and bool((x != prev).any()):
        new = x
        for _ in range(check_every):
            new = base + flow_sweep(new, W, links)
        x, prev, it = new, x, it + check_every
    return x, it


def finalize_uca(area, flats):
    """Flats carry no defined UCA."""
    return torch.where(flats, float("nan"), area)


def accumulate_update(delta0, W, receive_mask, push_mask=None, pit_src=None,
                      pit_dst=None, pit_w=None, max_iters=1_000_000,
                      check_every=4):
    """Propagate an edge delta through the drainage graph (the tile edge
    update): like :func:`accumulate` but with no base self-area, with
    receiving suppressed where ``receive_mask`` is 0 (edge pixels that were
    already initialised) and pushing suppressed where ``push_mask`` is 0
    (seeded done-but-not-todo edges keep their delta in the cell and never
    join the wave front).  The masks are floats of ``delta0``'s dtype; the
    pit terms go through :class:`PitLinks`.  One host read per
    ``check_every`` sweeps.  Returns ``(delta, n_sweeps)``."""
    links = None if pit_src is None else PitLinks(pit_src, pit_dst, pit_w)
    x = delta0
    prev = torch.full_like(delta0, -1.0)
    it = 0
    while it < max_iters and bool((x != prev).any()):
        new = x
        for _ in range(check_every):
            src = new if push_mask is None else new * push_mask
            new = delta0 + receive_mask * flow_sweep(src, W, links)
        x, prev, it = new, x, it + check_every
    return x, it


# sweeps of the flood between two host reads of its "changed" flag
FLOOD_SWEEPS_PER_READ = 4


def reachability(seed, W, pit_src=None, pit_dst=None, pit_w=None):
    """Boolean flood along drainage edges: all pixels reachable downstream
    from ``seed`` (which it includes).

    The pit hop marks a link's destination when its source is reached and
    its weight is positive.  The JAX version writes it as a scatter-max; here
    the links' hits are reduced into one flag per distinct destination (an
    integer ``amax``, order-free) and or-ed in at unique indices, so the hop
    is deterministic on CUDA.  A sweep past the fixed point changes nothing,
    so the loop reads the host once per :data:`FLOOD_SWEEPS_PER_READ`
    sweeps."""
    Wb = W > 0
    hop = None
    if pit_src is not None and pit_src.numel():
        dst_u, inverse = torch.unique(pit_dst.long(), return_inverse=True)
        hop = (pit_src.long(), pit_w > 0, dst_u, inverse)

    def sweep(t):
        new = t
        for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
            new = new | scatter_shift(Wb[k] & t, di, dj, False)
        if hop is not None:
            src, live, dst_u, inverse = hop
            contrib = (t.reshape(-1)[src] & live).to(torch.int32)
            hit = torch.zeros(dst_u.numel(), dtype=torch.int32,
                              device=t.device)
            hit.scatter_reduce_(0, inverse, contrib, "amax")
            flat = new.reshape(-1).clone()
            flat[dst_u] = flat[dst_u] | hit.bool()  # unique destinations
            new = flat.view(t.shape)
        return new

    t = seed
    while True:
        new = t
        for _ in range(FLOOD_SWEEPS_PER_READ):
            new = sweep(new)
        if not bool((new != t).any()):
            return new
        t = new


def grid_edge_mask(shape, device=None):
    """True on the outermost ring of an (n, m) canvas."""
    e = torch.zeros(shape, dtype=torch.bool, device=device)
    e[0, :] = e[-1, :] = True
    e[:, 0] = e[:, -1] = True
    return e


def seeds_and_edge_todo(W, section, elev):
    """Which grid-edge pixels still await inflow from a neighbouring tile
    (port of the JAX function of the same name): edge pixels with outflow
    whose section faces into the tile, plus corners that have outflow or no
    inflow."""
    n, m = elev.shape
    tol = 1e-2
    outflow = torch.zeros_like(elev)
    inflow = torch.zeros_like(elev)
    for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
        outflow = outflow + W[k]
        inflow = inflow + scatter_shift(W[k], di, dj, 0.0)

    def facing(out_edge, sec_edge, sections):
        want = torch.tensor(sections, dtype=sec_edge.dtype,
                            device=sec_edge.device)
        return (out_edge > tol) & torch.isin(sec_edge, want)

    edge_todo = torch.zeros((n, m), dtype=torch.bool, device=elev.device)
    edge_todo[:, 0] = facing(outflow[:, 0], section[:, 0], [6, 7, 0, 1])
    edge_todo[:, -1] = facing(outflow[:, -1], section[:, -1], [2, 3, 4, 5])
    edge_todo[0, :] = facing(outflow[0, :], section[0, :], [4, 5, 6, 7])
    edge_todo[-1, :] = facing(outflow[-1, :], section[-1, :], [0, 1, 2, 3])
    for ci, cj in ((0, 0), (0, m - 1), (n - 1, 0), (n - 1, m - 1)):
        passthrough = (outflow[ci, cj] > tol) | (inflow[ci, cj] < tol)
        edge_todo[ci, cj] = edge_todo[ci, cj] | passthrough
    return edge_todo
