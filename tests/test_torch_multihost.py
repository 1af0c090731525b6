"""pydem_tpu_torch.parallel.multihost: two gloo processes, one row band
each, run ``run_global`` (and the sharded pit solver) and must equal one
process, bit for bit.

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
res = {k: out[k].numpy() for k in ("mag", "direction", "flats", "uca", "twi")}
res["rounds"] = out["uca_sweeps"]
if solver == "blocked":
    ones = torch.ones(n, dtype=torch.float64)
    _m, _d, _f, W, base = sharded.terrain_pre(torch.from_numpy(elev),
                                              ones[1:], ones[1:], ones, ones)
    links = [torch.from_numpy(np.load(out_fn + ".links.npz")[k])
             for k in ("src", "dst", "w")]
    area, rounds = sharded.accumulate_sharded_pits(
        base.contiguous(), W, multihost.global_mesh(), *links, B=8)
    res["pits_area"], res["pits_rounds"] = area.numpy(), rounds
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

    ones = torch.ones(N, dtype=torch.float64)
    want = sharded.terrain_step(_elev(), ones[1:], ones[1:], ones, ones,
                                uca_solver=solver)
    for key in ("mag", "direction", "flats", "uca", "twi"):
        np.testing.assert_array_equal(np.nan_to_num(got[key]),
                                      np.nan_to_num(want[key].numpy()),
                                      err_msg=key)
    assert int(got["rounds"]) == want["uca_sweeps"]
    if solver == "blocked":
        _m, _d, _f, W, base = sharded.terrain_pre(_elev(), ones[1:],
                                                  ones[1:], ones, ones)
        area, rounds = ub.accumulate_blocked_pits_gs(
            base.contiguous(), W,
            *(torch.from_numpy(links[k]) for k in ("src", "dst", "w")), B=8)
        np.testing.assert_array_equal(got["pits_area"], area.numpy())
        assert int(got["pits_rounds"]) == rounds
