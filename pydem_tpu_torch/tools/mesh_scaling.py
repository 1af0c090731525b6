"""Mesh scaling sweep of the sharded UCA solve.

Counterpart of ``tools/mesh_scaling.py``.  For each mesh shape: the blocked
UCA rounds to convergence (``sharded_uca``; in the TPU's order, each
shard its own sequential grid, so the rounds are the shape's own, and the
1×1 mesh's are one device's), the ring bytes a round
exchanges (every shard receives a 1-px ring of float32), and the
exchange / relax / full-round times with the overlap fraction of
:func:`~pydem_tpu_torch.parallel.sharded.measure_halo_overlap`.  Then the
flat-region label flood, on one device against ``label_flood_sharded``.

Shapes: 1×1, 1×2 and 2×2 as shards on one device, then, where several
cards are visible, one shard a card (1×2 over two cards, 2×2 over four).
The JAX tool runs a virtual mesh of CPU devices instead; with ``--device
cpu`` this one runs its shapes as shards on the CPU.

Run: ``python -m pydem_tpu_torch.tools.mesh_scaling [--n 512] [--device
cpu]`` (on the GPU unless ``--device cpu`` is given).  Prints markdown
tables.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

SHAPES = ((1, 1), (1, 2), (2, 2))


def cone(n):
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = (1 - np.sqrt(x**2 + y**2) / np.sqrt(2.0)).astype("float32")
    return elev - elev.min() + 0.05


def meshes(device):
    """(label, mesh) of every shape: shards on ``device``, then one shard a
    card where the cards allow it."""
    import torch

    from ..parallel.mesh import make_mesh

    out = [("%dx%d on %s" % (gy, gx, device),
            make_mesh([device] * (gy * gx), (gy, gx))) for gy, gx in SHAPES]
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        for gy, gx in SHAPES[1:]:
            if gy * gx <= cards:
                out.append(("%dx%d, one shard a card" % (gy, gx), make_mesh(
                    [torch.device("cuda", k) for k in range(gy * gx)],
                    (gy, gx))))
    return out


def _sync(mesh):
    import torch

    if mesh.device_type == "cuda":
        for d, _ks in mesh.devices_of():
            torch.cuda.synchronize(d)


def scaling(n=512, device="cuda", overlap_rounds=4):
    """The sweep on the ``n``² cone; prints the tables and returns
    ``{"rows": [...], "flood": [...]}``."""
    import torch

    from ..core.flats_device import _flat_mask
    from ..core.slope_direction import label_flood
    from ..parallel.sharded import (label_flood_sharded,
                                    measure_halo_overlap, sharded_uca,
                                    terrain_pre)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh_scaling(device=%r): torch.cuda is not "
                           "available (--device cpu runs on the CPU)"
                           % str(device))
    dtype = torch.float32
    elev = torch.as_tensor(cone(n), dtype=dtype, device=device)
    ones = lambda k: torch.ones(k, dtype=dtype, device=device)  # noqa: E731
    _mag, _d, _f, W, base = terrain_pre(elev, ones(n - 1), ones(n - 1),
                                        ones(n), ones(n))
    rows = []
    for label, mesh in meshes(device):
        gy, gx = mesh.shape
        _area, rounds = sharded_uca(base, W, mesh, uca_solver="blocked")
        n_l, m_l = n // gy, n // gx
        ring_px = 2 * (n_l + 2) + 2 * m_l  # rows, then extended columns
        t = measure_halo_overlap(base, W, mesh, rounds=overlap_rounds)
        rows.append({"mesh": label, "shape": [gy, gx], "rounds": int(rounds),
                     "ring_bytes_per_round": ring_px * 4 * gy * gx,
                     "t_exchange_per_round": t["t_exchange_per_round"],
                     "t_relax_per_round": t["t_relax_per_round"],
                     "t_full_per_round": t["t_full_per_round"],
                     "overlap_fraction": t["overlap_fraction"],
                     "timer": t["timer"]})

    print("| mesh | UCA rounds | ring B/round | t_exch (s) | t_relax (s) "
          "| t_round (s) | overlap | timer |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        ov = r["overlap_fraction"]
        print("| %s | %d | %d | %.6f | %.6f | %.6f | %s | %s |" % (
            r["mesh"], r["rounds"], r["ring_bytes_per_round"],
            r["t_exchange_per_round"], r["t_relax_per_round"],
            r["t_full_per_round"], "n/a" if ov is None else "%.2f" % ov,
            r["timer"]), flush=True)

    # the label flood (the one non-stencil op of the pipeline) on a
    # quantized, flats-heavy canvas: the global flood on one device, the
    # sharded flood (local components, then ring adoption) on a mesh
    eq = torch.floor(elev * 8.0) / 8.0
    flat = _flat_mask(eq, False)
    flood = []
    print()
    print("| mesh | flat px | flood impl | label_flood (s, best of 3) |")
    print("|---|---|---|---|")
    for label, mesh in meshes(device):
        if mesh.size == 1:
            impl = "global"

            def prog():
                return label_flood(flat, eq)[0]
        else:
            impl = "sharded"

            def prog(mesh=mesh):
                return label_flood_sharded(flat, eq, mesh)[0]
        prog()
        times = []
        for _ in range(3):
            _sync(mesh)
            t0 = time.perf_counter()
            prog()
            _sync(mesh)
            times.append(time.perf_counter() - t0)
        flood.append({"mesh": label, "impl": impl, "seconds": min(times),
                      "reps": times})
        print("| %s | %d | %s | %.4f |" % (label, int(flat.sum()), impl,
                                            min(times)), flush=True)
    return {"rows": rows, "flood": flood}


def main(argv=None):
    ap = argparse.ArgumentParser(description="mesh scaling sweep of the "
                                             "sharded UCA solve")
    ap.add_argument("--n", type=int, default=512, help="canvas side")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the shards (default cuda; "
                         "--device cpu for the CPU)")
    args = ap.parse_args(argv)
    return scaling(args.n, args.device)


if __name__ == "__main__":
    main()
