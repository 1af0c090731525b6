"""The full terrain step on one device.

Port of ``terrain_step`` from ``pydem_tpu/parallel/sharded.py``.  The mesh
functions of that module (sharded label flood, sharded UCA, halo exchange)
are not ported yet; they need ``torch.distributed`` and more than one GPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.flats_device import fill_flats_device
from ..core.receivers import receiver_weights, section_proportion
from ..core.slope_direction import find_flats_edges, slopes_directions
from ..core.twi import twi as twi_fn
from ..core.uca import accumulate, base_area, finalize_uca, flow_sweep

FLAT_ID_INT = -1


def _block_size(n, m):
    """Relaxation block side: 64 (the largest the CUDA kernel takes), or 16
    for canvases smaller than one 64-block."""
    return 64 if min(n, m) >= 64 else 16


def terrain_pre(elev, dX, dY, dX2, dY2, fill_flats=False):
    """The stencil first half of the terrain step: slope/direction, flat
    extension, flow splitting, receiver weights, base area, on the device of
    ``elev``; with ``fill_flats``, the elevation is first conditioned by
    :func:`~pydem_tpu_torch.core.flats_device.fill_flats_device`.  Returns
    ``(mag, direction, flats, W, base)``."""
    dX, dY, dX2, dY2 = (torch.as_tensor(a, dtype=elev.dtype, device=elev.device)
                        for a in (dX, dY, dX2, dY2))
    if fill_flats:
        elev = fill_flats_device(elev)
    mag, direction = slopes_directions(elev, dX, dY)
    flats = find_flats_edges(elev, mag)
    direction = torch.where(flats, FLAT_ID_INT, direction)
    mag = torch.where(flats, FLAT_ID_INT, mag)
    section, proportion = section_proportion(direction, flats, dX, dY)
    W = receiver_weights(section, proportion, elev)
    base = base_area(dX2, dY2, elev.shape, elev.dtype)
    return mag, direction, flats, W, base


def terrain_step(elev, dX, dY, dX2, dY2, n_sweeps=None, uca_solver="jacobi",
                 fill_flats=False):
    """(Flat filling →) slope/direction → flats → section/proportion →
    receiver weights → UCA fixed point → TWI, on the device of ``elev``.

    With ``n_sweeps`` set, runs that many UCA sweeps; otherwise iterates to
    the fixed point with ``uca_solver``: ``"jacobi"`` (global sweeps) or
    ``"blocked"`` (block relaxation rounds, the CUDA kernel on a GPU; the
    canvas is zero-padded to the block grid, which is exact since pad pixels
    carry no weight and no base area).  Returns a dict with ``mag``,
    ``direction``, ``flats``, ``uca``, ``twi`` and ``uca_sweeps`` (sweeps,
    or rounds for the blocked solver, as an int).
    """
    if uca_solver not in ("jacobi", "blocked"):
        raise ValueError("uca_solver must be 'jacobi' or 'blocked', got %r"
                         % (uca_solver,))
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
        base_p = F.pad(base, (0, pm, 0, pn))
        W_p = F.pad(W, (0, pm, 0, pn))
        area, sweeps = accumulate_blocked_gs(base_p, W_p, B=B)
        area = area[:n, :m]
    else:
        area, sweeps = accumulate(base, W)
    uca = finalize_uca(area, flats)

    # nanmin(base): torch has no NaN-ignoring min
    min_area = torch.where(torch.isnan(base), torch.inf, base).min()
    twi = twi_fn(uca, mag, min_area)
    return dict(mag=mag, direction=direction, flats=flats, uca=uca, twi=twi,
                uca_sweeps=sweeps)
