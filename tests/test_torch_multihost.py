"""pydem_tpu_torch.parallel.multihost: two gloo processes, one row band
each, run ``run_global`` (and the sharded pit solver) and must equal one
process running the same path on a mesh of the same shape, bit for bit,
rounds included, and reach one device's fixed point bit for bit.

The back end is ``torch.distributed`` (rings by point-to-point sends, the
convergence sum by ``all_reduce``) on the CPU; rank 0 writes what it got.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pydem_tpu_torch.ops import uca_block as ub
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.parallel.mesh import make_mesh


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32

_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from pydem_tpu_torch.parallel import multihost, sharded

url, pid, out_fn, solver = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
multihost.initialize(url, num_processes=2, process_id=pid)
n = %d
x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
elev = np.round((1 - np.sqrt(x ** 2 + y ** 2) / np.sqrt(2.0)) * 40) / 40 + 0.05
band = elev[pid * (n // 2): (pid + 1) * (n // 2)]
out = multihost.run_global(band, np.ones(n - 1), np.ones(n - 1), np.ones(n),
                           np.ones(n), uca_solver=solver)
res = {k: out[k].assemble().numpy()
       for k in ("mag", "direction", "flats", "uca", "twi")}
res["rounds"] = out["uca_sweeps"]
if solver == "blocked":
    ones = torch.ones(n, dtype=torch.float64)
    _m, _d, _f, W, base = sharded.terrain_pre(torch.from_numpy(elev),
                                              ones[1:], ones[1:], ones, ones)
    links = [torch.from_numpy(np.load(out_fn + ".links.npz")[k])
             for k in ("src", "dst", "w")]
    area, rounds = sharded.accumulate_sharded_pits(
        base.contiguous(), W, multihost.global_mesh(), *links, B=8)
    res["pits_area"], res["pits_rounds"] = area.assemble().numpy(), rounds
if pid == 0:
    np.savez(out_fn, **res)
""" % N


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _elev():
    x, y = np.mgrid[-1:1:complex(0, N), -1:1:complex(0, N)]
    e = np.round((1 - np.sqrt(x ** 2 + y ** 2) / np.sqrt(2.0)) * 40) / 40
    return torch.from_numpy(e + 0.05)


@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
def test_two_process_run_global(tmp_path, solver):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    out_fn = str(tmp_path / "out.npz")
    rng = np.random.RandomState(3)
    dst_i = rng.randint(8, N, 10).repeat(3)
    links = dict(dst=dst_i * N + rng.randint(0, N, 30),
                 src=(dst_i - rng.randint(2, 6, 30)) * N
                 + rng.randint(0, N, 30),
                 w=rng.uniform(0, 0.5, 30))
    np.savez(out_fn + ".links.npz", **links)
    url = "tcp://127.0.0.1:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), url, str(pid), out_fn, solver],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = np.load(out_fn)

    # the bitwise references: the same path in one process on a mesh of the
    # same shape (two row bands), values and rounds; and one device's
    # terrain_step, the same fixed point (the mesh's rounds are its shape's:
    # each band runs its own sequential grid in the TPU's order)
    ones = torch.ones(N, dtype=torch.float64)
    bands = make_mesh([torch.device("cpu")] * 2, (2, 1))
    want = sharded.run_sharded(_elev(), ones[1:], ones[1:], ones, ones,
                               mesh=bands, uca_solver=solver)
    step = sharded.terrain_step(_elev(), ones[1:], ones[1:], ones, ones,
                                uca_solver=solver)
    for key in ("mag", "direction", "flats", "uca", "twi"):
        np.testing.assert_array_equal(np.nan_to_num(got[key]),
                                      np.nan_to_num(want[key].numpy()),
                                      err_msg=key)
        np.testing.assert_array_equal(np.nan_to_num(got[key]),
                                      np.nan_to_num(step[key].numpy()),
                                      err_msg=key)
    assert int(got["rounds"]) == want["uca_sweeps"]
    if solver == "jacobi":
        assert int(got["rounds"]) == step["uca_sweeps"]
    else:
        _m, _d, _f, W, base = sharded.terrain_pre(_elev(), ones[1:],
                                                  ones[1:], ones, ones)
        pits = [torch.from_numpy(links[k]) for k in ("src", "dst", "w")]
        area, rounds = sharded.accumulate_sharded_pits(
            base.contiguous(), W, bands, *pits, B=8)
        np.testing.assert_array_equal(got["pits_area"],
                                      area.assemble().numpy())
        assert int(got["pits_rounds"]) == rounds
        gs, _gs_rounds = ub.accumulate_blocked_pits_gs(base.contiguous(), W,
                                                       *pits, B=8)
        np.testing.assert_array_equal(got["pits_area"], gs.numpy())


# -- four processes, a 2x2 mesh: DistExchange against LocalExchange ----------

_FOUR_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from pydem_tpu_torch.parallel import multihost, sharded
from pydem_tpu_torch.parallel.mesh import split

url, pid, out_fn = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(url, num_processes=4, process_id=pid)
mesh = multihost.global_mesh(shape=(2, 2))
z = np.load(out_fn + ".in.npz")
res = {}
for d in (1, 2):
    for name in ("f", "i"):
        plane = split(torch.from_numpy(z[name]), mesh, ring=d, fill=-7)
        res["halo%d_%s" % (d, name)] = mesh.exchange().halo(plane, d)[0]
vals = [torch.tensor(float(z["vals"][pid]), dtype=torch.float64)]
for op in ("sum", "min", "max"):
    res["reduce_" + op] = mesh.exchange().reduce(vals, op)
res["gather"] = mesh.exchange().gather(split(torch.from_numpy(z["f"]),
                                             mesh)[0])
area, rounds = sharded.accumulate_sharded(
    torch.from_numpy(z["base"]), torch.from_numpy(z["W"]), mesh, B=8)
res["area"], res["rounds"] = area.assemble(), torch.tensor(rounds)
# run_global on (4, 1) row bands that are not whole K1 blocks (re-cut
# between the ranks): each rank's outputs stay its band
canvas = z["canvas"]
band = canvas.shape[0] // 4
n = canvas.shape[0]
ones = np.ones(n)
out = multihost.run_global(canvas[pid * band: (pid + 1) * band], ones[1:],
                           ones[1:], ones, ones, uca_solver="blocked")
for k in ("mag", "direction", "flats", "uca", "twi"):
    res["rg_band_" + k] = out[k].local_shards()[0]
    res["rg_whole_" + k] = out[k].assemble()
res["rg_shards"] = torch.tensor(len(out["uca"].local_shards()))
res["rg_rounds"] = torch.tensor(out["uca_sweeps"])
try:
    np.asarray(out["uca"])
    res["rg_numpy_refused"] = torch.tensor(0)
except ValueError:
    res["rg_numpy_refused"] = torch.tensor(1)
np.savez(out_fn + ".%d.npz" % pid, **{k: v.numpy() for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four gloo processes on a 2x2 global mesh: each rank's ringed planes
    after ``halo`` (depth 1 and 2, float64 and int32), the three
    reductions, the gathered canvas and the sharded K1 solve; then
    ``run_global(blocked)`` on the default (4, 1) mesh of row bands."""
    from pydem_tpu_torch import fixtures

    tmp = tmp_path_factory.mktemp("four")
    rng = np.random.RandomState(11)
    n = 32
    elev, _a, _u = fixtures.get_test_case(13, n)
    ones = torch.ones(n, dtype=torch.float64)
    _m, _d, _f, W, base = sharded.terrain_pre(
        torch.from_numpy(np.ascontiguousarray(elev, "float64")), ones[1:],
        ones[1:], ones, ones)
    canvas, _a, _u = fixtures.get_test_case(5, RG_SHAPE[0])
    inputs = dict(f=rng.rand(n, n), i=rng.randint(0, 99, (n, n)).astype(
        np.int32), vals=rng.rand(4), base=base.contiguous().numpy(),
        W=W.numpy(), canvas=np.ascontiguousarray(
            canvas[:, : RG_SHAPE[1]], "float64"))
    out_fn = str(tmp / "out")
    np.savez(out_fn + ".in.npz", **inputs)
    script = tmp / "rank.py"
    script.write_text(_FOUR_SCRIPT)
    url = "tcp://127.0.0.1:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), url, str(pid), out_fn],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for pid in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    return inputs, [dict(np.load(out_fn + ".%d.npz" % pid))
                    for pid in range(4)]


# run_global's canvas: 10-row bands, not whole 16-blocks, so the solve
# re-cuts them between the ranks
RG_SHAPE = (40, 24)
RG_KEYS = ("mag", "direction", "flats", "uca", "twi")


def _local_mesh():
    from pydem_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cpu")] * 4, (2, 2))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", ["f", "i"])
def test_four_rank_halo_equals_local(four_ranks, depth, name):
    """Each rank's rings (rows, then whole columns, corners through the
    y-neighbour) equal LocalExchange's for the same shard, bit for bit."""
    from pydem_tpu_torch.parallel.mesh import split

    inputs, ranks = four_ranks
    mesh = _local_mesh()
    want = mesh.exchange().halo(
        split(torch.from_numpy(inputs[name]), mesh, ring=depth, fill=-7),
        depth)
    for pid in range(4):
        np.testing.assert_array_equal(ranks[pid]["halo%d_%s" % (depth, name)],
                                      want[pid].numpy())


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_four_rank_reduce_equals_local(four_ranks, op):
    inputs, ranks = four_ranks
    want = _local_mesh().exchange().reduce(
        [torch.tensor(float(v), dtype=torch.float64)
         for v in inputs["vals"]], op)
    for pid in range(4):
        assert float(ranks[pid]["reduce_" + op]) == float(want)


def test_four_rank_gather_and_solve_equal_local(four_ranks):
    """The gathered canvas is the input on every rank; the sharded K1
    solve over the four ranks equals the in-process 2x2 solve, values and
    rounds, and reaches the fixed point of the solve on a 1x1 mesh bit for
    bit, which is one device's Gauss-Seidel solve, rounds included."""
    inputs, ranks = four_ranks
    base, W = torch.from_numpy(inputs["base"]), torch.from_numpy(inputs["W"])
    area, rounds = sharded.accumulate_sharded(base, W, _local_mesh(), B=8)
    area = area.assemble()
    one, one_rounds = sharded.accumulate_sharded(
        base, W, make_mesh([torch.device("cpu")], (1, 1)), B=8)
    assert torch.equal(area, one.assemble())
    gs, gs_rounds = ub.accumulate_blocked_gs(base, W, B=8)
    assert one_rounds == gs_rounds and torch.equal(one.assemble(), gs)
    for pid in range(4):
        np.testing.assert_array_equal(ranks[pid]["gather"], inputs["f"])
        np.testing.assert_array_equal(ranks[pid]["area"], area.numpy())
        assert int(ranks[pid]["rounds"]) == rounds


def test_four_rank_run_global_holds_only_its_band(four_ranks):
    """run_global leaves each output on its rank: one shard, the rank's
    10-row band, equal to those rows of the gathered canvas; np.asarray of
    a canvas that spans other ranks is refused (assemble() gathers)."""
    _inputs, ranks = four_ranks
    band = RG_SHAPE[0] // 4
    for pid in range(4):
        r = ranks[pid]
        assert int(r["rg_shards"]) == 1 and int(r["rg_numpy_refused"]) == 1
        for key in RG_KEYS:
            local, whole = r["rg_band_" + key], r["rg_whole_" + key]
            assert local.shape == (band, RG_SHAPE[1]), key
            np.testing.assert_array_equal(
                local, whole[pid * band: (pid + 1) * band], err_msg=key)
            np.testing.assert_array_equal(whole, ranks[0]["rg_whole_" + key],
                                          err_msg=key)


def test_four_rank_run_global_equals_run_sharded_and_jax(four_ranks):
    """The gathered bands equal run_sharded(blocked) on a local (4, 1) mesh
    bit for bit, rounds too, and the JAX run_sharded on a JAX (4, 1) mesh
    (NaN patterns equal, values to decimal=10)."""
    from functools import partial

    import jax

    from pydem_tpu.parallel import sharded as j_sharded
    from pydem_tpu_torch.parallel.mesh import make_mesh

    inputs, ranks = four_ranks
    canvas = inputs["canvas"]
    n = canvas.shape[0]
    rows = (np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n))
    mesh = make_mesh([torch.device("cpu")] * 4, (4, 1))
    want = sharded.run_sharded(canvas, *rows, mesh=mesh, uca_solver="blocked")
    jmesh = j_sharded.make_mesh(jax.devices()[:4], shape=(4, 1))
    jax_out = jax.jit(partial(j_sharded.run_sharded, mesh=jmesh,
                              uca_solver="jacobi"))(canvas, *rows)
    got = ranks[0]
    assert int(got["rg_rounds"]) == want["uca_sweeps"]
    for key in RG_KEYS:
        g = got["rg_whole_" + key]
        w = np.asarray(want[key])
        assert g.dtype == w.dtype and np.array_equal(
            g, w, equal_nan=g.dtype.kind == "f"), key
        j = np.asarray(jax_out[key])
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(j),
                                          err_msg=key)
            np.testing.assert_array_almost_equal(
                np.nan_to_num(g), np.nan_to_num(j), decimal=10, err_msg=key)
        else:
            np.testing.assert_array_equal(g, j, err_msg=key)
