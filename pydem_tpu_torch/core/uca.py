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
