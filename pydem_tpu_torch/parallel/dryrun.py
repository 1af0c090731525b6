"""A quick run of every mesh path over an n-shard mesh.

Port of ``dryrun_multichip`` in the repository's ``__graft_entry__.py``:
the sharded terrain step (fixed sweeps, and the blocked solver checked
against one device's in-core solve: a 1×1 mesh the same fixed point
bitwise, the mesh's stencils bitwise and its uca within the bench gate), ``ProcessManager(mesh=...)`` on a tile directory, and
the manager's out-of-core engine over the mesh, at small sizes.

    python -m pydem_tpu_torch.parallel.dryrun 4            # on the GPU
    python -m pydem_tpu_torch.parallel.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import warnings

import numpy as np
import torch

from .. import default_dtype


def _devices(n_devices, device):
    """``n_devices`` cells: the CPU, or the visible GPUs in turn (several
    shards share a card when there are fewer cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n_devices
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: torch.cuda is not available; "
                           "pass device='cpu'")
    count = torch.cuda.device_count()
    return [torch.device("cuda", k % count) for k in range(n_devices)]


def dryrun_multichip(n_devices, device="cuda"):
    """Run the mesh paths on an ``n_devices``-shard mesh of ``device`` and
    check them; returns a dict of what ran."""
    from .. import fixtures, manager
    from .mesh import make_mesh
    from .sharded import run_sharded, terrain_step

    mesh = make_mesh(_devices(n_devices, device))
    gy, gx = mesh.shape
    dev = mesh.devices.flat[0]
    dt = default_dtype(dev)
    n, m = max(64, 32 * gy), max(64, 32 * gx)
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, m)]
    elev = torch.as_tensor(1 - np.sqrt(x ** 2 + y ** 2) / np.sqrt(2.0),
                           dtype=dt).to(dev)
    rows = (torch.ones(n - 1, dtype=dt, device=dev),) * 2 + (
        torch.ones(n, dtype=dt, device=dev),) * 2

    out = run_sharded(elev, *rows, mesh=mesh, n_sweeps=8)
    uca = np.asarray(out["uca"])  # the shards, each into its host slice
    if uca.shape != (n, m) or not np.isfinite(uca[1:-1, 1:-1]).any():
        raise AssertionError("sharded sweeps: uca %s" % (uca.shape,))

    # the blocked solver against one device's terrain_step (the TPU's
    # order on the whole canvas): a 1x1 mesh the same fixed point bitwise
    # (its rounds may differ: the in-core solver threads a frontier, the
    # mesh's rounds none); the mesh, whose shards each run their own grid,
    # its stencils bitwise and its uca within the JAX bench gate of the cone
    out_b = run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")
    one = run_sharded(elev, *rows, mesh=make_mesh([dev], (1, 1)),
                      uca_solver="blocked")
    single = terrain_step(elev, *rows, uca_solver="blocked")
    for key in ("mag", "direction", "flats", "uca", "twi"):
        b = torch.nan_to_num(single[key].double())
        if not torch.equal(torch.nan_to_num(one[key].assemble(dev).double()),
                           b):
            raise AssertionError("sharded blocked step: %s of a 1x1 mesh "
                                 "differs from one device's" % key)
        for view, (r0, c0, h, w) in out_b[key].views():
            got = torch.nan_to_num(view.double())
            want = b[r0: r0 + h, c0: c0 + w].to(view.device)
            same = (torch.allclose(got, want, rtol=1e-5, atol=1e-3)
                    if key in ("uca", "twi") else torch.equal(got, want))
            if not same:
                raise AssertionError("sharded blocked step: %s outside the "
                                     "gate of one device's" % key)

    twis = {}
    # small super-blocks, which the engine's block size divides: on a GPU
    # it takes 128 or 256 (the JAX engine's rule on a TPU), on the CPU 16
    small = (64, 32) if dev.type == "cpu" else (128, 128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tag, kw in (("manager", dict(superblock=small[0])),
                        ("out_of_core", dict(out_of_core=True,
                                             superblock=small[1]))):
            with tempfile.TemporaryDirectory() as d:
                chunks = fixtures.mk_test_multifile(
                    33, max(n, 16), d, nx_grid=2, ny_grid=2, nx_overlap=2,
                    ny_overlap=2)
                pm = manager.ProcessManager(
                    in_path=chunks, mesh=mesh, device=dev.type,
                    dem_proc_kwargs={"uca_solver": "blocked"}, **kw)
                pm.process_twi()
                twi = pm.out_file["twi"]
                if not np.isfinite(twi).any():
                    raise AssertionError("%s on the mesh: no finite twi"
                                         % tag)
                twis[tag] = int(np.isfinite(twi).sum())
    res = dict(mesh=list(mesh.shape), canvas=[n, m],
               uca_sum=float(np.nansum(uca)),
               blocked_rounds=out_b["uca_sweeps"],
               manager_twi_finite=twis["manager"],
               ooc_mesh_twi_finite=twis["out_of_core"])
    print("dryrun_multichip OK: %s" % res, flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dryrun_multichip(a.n_devices, a.device)


if __name__ == "__main__":
    main()
