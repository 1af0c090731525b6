"""pydem_tpu_torch's terrain_step == pydem_tpu's terrain_step (CPU, float64).

The JAX reference runs with ``jax.disable_jit()``: jitted on the CPU, XLA
contracts ``s2*s2 + s1*s1`` in the facet sweep into a fused multiply-add in
spite of the ``optimization_barrier`` meant to stop it, which flips a
near-tie facet of the symmetric cone (fixture 33, pixel (6, 25)).  Op by op,
the JAX program rounds as numpy and the reference do, and as eager PyTorch
does.  The JAX ``"blocked"`` mode would compile the Pallas kernel for the CPU
without interpret mode, so the jacobi and ``n_sweeps`` modes are the
references.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import fixtures
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch import default_dtype
from pydem_tpu_torch.convert import state_from_numpy
from pydem_tpu_torch.parallel import sharded as t_sharded

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32


def _inputs(case, n=N):
    elev, _a, _u = fixtures.get_test_case(case, n)
    return dict(elev=elev, dX=np.ones(n - 1), dY=np.ones(n - 1),
                dX2=np.ones(n), dY2=np.ones(n))


def _check(got, want):
    np.testing.assert_array_equal(got["flats"].numpy(),
                                  np.asarray(want["flats"]))
    for key in ("mag", "direction"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-12, atol=0, err_msg=key)
    for key in ("uca", "twi"):
        g, w = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        np.testing.assert_array_almost_equal(np.nan_to_num(g),
                                             np.nan_to_num(w), decimal=10,
                                             err_msg=key)


def _jax_blocked_rounds(args):
    """The rounds of the JAX ``terrain_step(uca_solver="blocked")``: its
    ``accumulate_blocked_gs`` at its B (256, or 128 under 256) on its own
    planes zero-padded to the block grid, the Pallas kernel in interpret
    mode (compiled for the CPU it would not run)."""
    from pydem_tpu.ops import uca_block as j_ub

    n, m = args[0].shape
    B = 256 if min(n, m) >= 256 else 128
    with jax.disable_jit():
        _mag, _dir, _flats, W, base = j_sharded.terrain_pre(*args)
    pn, pm = (-n) % B, (-m) % B
    _area, rounds = j_ub.accumulate_blocked_gs(
        jnp.pad(base, ((0, pn), (0, pm))),
        jnp.pad(W, ((0, 0), (0, pn), (0, pm))), B=B, interpret=True)
    return int(rounds)


@pytest.mark.parametrize("case", [33, 5, 24, 13])
def test_terrain_step_matches_jax(case):
    arrays = _inputs(case)
    args = [jnp.asarray(arrays[k]) for k in ("elev", "dX", "dY", "dX2", "dY2")]
    with jax.disable_jit():
        want_j = j_sharded.terrain_step(*args, uca_solver="jacobi")
        want_s = j_sharded.terrain_step(*args, n_sweeps=32)
    s = state_from_numpy(arrays, "cpu", default_dtype("cpu"))
    targs = [s[k] for k in ("elev", "dX", "dY", "dX2", "dY2")]

    got = t_sharded.terrain_step(*targs, uca_solver="jacobi")
    _check(got, want_j)
    assert got["uca_sweeps"] == int(want_j["uca_sweeps"])

    got = t_sharded.terrain_step(*targs, uca_solver="blocked")
    _check(got, want_j)
    assert got["uca_sweeps"] == _jax_blocked_rounds(args)

    got = t_sharded.terrain_step(*targs, n_sweeps=32)
    _check(got, want_s)
    assert got["uca_sweeps"] == 32


@pytest.mark.parametrize("case", [33, 5, 24, 13])
def test_terrain_pre_matches_jax(case):
    arrays = _inputs(case)
    args = [jnp.asarray(arrays[k]) for k in ("elev", "dX", "dY", "dX2", "dY2")]
    with jax.disable_jit():
        want = j_sharded.terrain_pre(*args)
    s = state_from_numpy(arrays, "cpu", default_dtype("cpu"))
    got = t_sharded.terrain_pre(*[s[k] for k in ("elev", "dX", "dY", "dX2",
                                                 "dY2")])
    names = ("mag", "direction", "flats", "W", "base")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("flats", "base"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:  # atan2 may differ by an ulp between libraries
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=name)


def test_blocked_pads_ragged_canvas():
    """A canvas that is no multiple of the block size is zero-padded for the
    blocked solver, which is exact: it matches jacobi on the same canvas."""
    elev, _a, _u = fixtures.get_test_case(30, 80)
    elev = torch.from_numpy(elev[:70, :75].copy())
    args = (torch.ones(69, dtype=elev.dtype), torch.ones(69, dtype=elev.dtype),
            torch.ones(70, dtype=elev.dtype), torch.ones(70, dtype=elev.dtype))
    b = t_sharded.terrain_step(elev, *args, uca_solver="blocked")
    j = t_sharded.terrain_step(elev, *args, uca_solver="jacobi")
    for key in ("uca", "twi"):
        assert b[key].shape == (70, 75)
        np.testing.assert_array_almost_equal(
            np.nan_to_num(b[key].numpy()), np.nan_to_num(j[key].numpy()),
            decimal=10)
    with pytest.raises(ValueError, match="uca_solver"):
        t_sharded.terrain_step(elev, *args, uca_solver="gauss")


def test_state_from_numpy_keeps_integer_and_bool_planes():
    s = state_from_numpy(dict(W=np.ones((8, 2, 2)),
                              K=np.full((2, 2), 255, np.int32),
                              flats=np.zeros((2, 2), bool)),
                         "cpu", torch.float32)
    assert s["W"].dtype == torch.float32
    assert s["K"].dtype == torch.int32
    assert s["flats"].dtype == torch.bool
    assert default_dtype("cpu") == torch.float64
    assert default_dtype("cuda") == torch.float32


def test_port_imports_neither_jax_nor_pydem_tpu():
    code = (
        "import sys, numpy as np, torch\n"
        "import pydem_tpu_torch\n"
        "from pydem_tpu_torch.convert import state_from_numpy\n"
        "from pydem_tpu_torch.ops import _build, pit_growth, uca_block\n"
        "from pydem_tpu_torch.parallel.sharded import terrain_step\n"
        "from pydem_tpu_torch import native\n"
        "from pydem_tpu_torch.api import DEMProcessor\n"
        "from pydem_tpu_torch.core import conditioning, flats_device\n"
        "n = 24\n"
        "x, y = np.mgrid[-1:1:24j, -1:1:24j]\n"
        "e = torch.from_numpy(1 - np.sqrt(x**2 + y**2))\n"
        "o = torch.ones(n - 1, dtype=e.dtype); o2 = torch.ones(n, dtype=e.dtype)\n"
        "for solver in ('jacobi', 'blocked'):\n"
        "    out = terrain_step(e, o, o, o2, o2, uca_solver=solver)\n"
        "    assert torch.isfinite(out['uca']).any()\n"
        "dp = DEMProcessor(elev=np.round(e.numpy() * 40) / 40,"
        " conditioning_backend='device', pit_backend='device', device='cpu')\n"
        "assert np.isfinite(dp.calc_twi()).any()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'pydem_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "ok"
