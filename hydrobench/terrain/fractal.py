"""Fractal terrain by spectral synthesis, made on the device.

A surface is fractional Brownian motion: complex white noise shaped to an
amplitude of ``k^-(H + 1)`` over the spatial frequency ``k`` (a power
spectrum of ``k^-(2H + 2)``, Hurst exponent ``H``; eroded terrain reads
0.7-0.9), transformed back by one inverse FFT, scaled to ``relief_m``,
with a regional ``tilt_m`` falling from the west edge to the east one and
a ``base_m`` added.  With ``sea_share`` the lowest share of the tile
becomes sea, the product's nodata (NaN), after the surface is lowered so
that the coast lies at 0 m.  The land is then made depression-free by the
harness's own fill (:mod:`.fill`), the sea and the rim as outlets, with a
drop of ``fill_eps_m`` a pixel.

The pool holds ``pool`` (at most 8) tiles: rotations and flips of the one
surface that the traffic's ``surface_seed`` makes; a run's seed orders
them.  A rotation or flip keeps a surface depression-free and turns its
drainage against the solver's sweep orientations.  The parameters of each
traffic mix, and why, are in its file.
"""
from __future__ import annotations

import torch

from .fill import epsilon_fill


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded from any whole number
    (the driver's seeds exceed 32 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def spectral_surface(shape, hurst, gen, device):
    """fBm on ``shape`` scaled to [0, 1], float32."""
    n, m = shape
    ky = torch.fft.fftfreq(n, device=device)[:, None]
    kx = torch.fft.rfftfreq(m, device=device)[None, :]
    k = torch.sqrt(kx * kx + ky * ky)
    amp = torch.where(k > 0, k.clamp_min(1e-12) ** -(hurst + 1.0), 0.0)
    noise = torch.randn((2, n, m // 2 + 1), generator=gen, device=device)
    spec = torch.complex(noise[0] * amp, noise[1] * amp)
    z = torch.fft.irfft2(spec, s=(n, m))
    z = z - z.min()
    return (z / z.max()).float()


def dihedral(a, k):
    """The ``k``-th of the 8 rotations and flips of a square canvas."""
    a = torch.rot90(a, k % 4)
    return torch.flip(a, (1,)) if k >= 4 else a


def _quantile(a, q, sample=1 << 22):
    flat = a.reshape(-1)
    step = max(1, flat.numel() // sample)
    return torch.quantile(flat[::step].double(), q).to(a.dtype)


def surface(traffic, shape, gen, device):
    """One surface of the traffic mix: ``(elevation float32, sea mask)``."""
    t = traffic["terrain"]
    n, m = shape
    z = spectral_surface(shape, t["hurst"], gen, device) * t["relief_m"]
    x = torch.linspace(1.0, 0.0, m, device=device)[None, :]
    z = z + t["tilt_m"] * x + t["base_m"]
    sea = torch.zeros(shape, dtype=torch.bool, device=device)
    if t.get("sea_share", 0):
        z = z - _quantile(z, t["sea_share"])
        sea = z < 0
        z = torch.where(sea, 0.0, z)
    return epsilon_fill(z, sea, eps=t["fill_eps_m"]), sea


def make_pool(traffic, config, seed, device):
    """The cell's tiles as host arrays in the config's dtype, and the order
    of the window's passes over them.  The surface comes from the traffic
    file's ``surface_seed``, so every run seed gets the same tiles and the
    same work; the run's ``seed`` draws the order (a permutation)."""
    gen = generator(traffic["terrain"]["surface_seed"], device)
    z, sea = surface(traffic, tuple(config["shape"]), gen, device)
    z = torch.where(sea, float("nan"), z)  # the product's nodata
    pool = [dihedral(z, k).to(getattr(torch, config["dtype"])).cpu().numpy()
            for k in range(traffic["pool"])]
    return pool, pool_order(len(pool), seed, device)


def pool_order(size, seed, device):
    """The run's order of the pool's tiles: a permutation drawn from the
    seed, repeated pass after pass."""
    return torch.randperm(size, generator=generator(seed, device),
                          device=device).tolist()
