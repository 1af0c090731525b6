"""The TPU kernels' block sizes on the CPU, float64: the port's defaults
choose the JAX functions' B, its solvers at B = 128 and 256 return the JAX
solvers' rounds, and its mesh at the shard B = 32 and 8 the JAX mesh's.

The JAX solvers run their Pallas kernels in interpret mode, as the JAX
package's own tests run them; the port's side is the plain version, which
the CUDA kernels (at B = 128 and 256 a thread-block cluster a visit) equal
bit for bit on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Tolerances: block sizes and round counts exact; values to 10 decimals (the
JAX kernel's interpret-mode sums round differently in the last bits on the
CPU, ``tests/test_torch_oriented.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import api as j_api
from pydem_tpu import fixtures as j_fixtures
from pydem_tpu import outofcore as j_ooc
from pydem_tpu.ops import uca_block as j_ub
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch import api as t_api
from pydem_tpu_torch import outofcore as t_ooc
from pydem_tpu_torch.convert import state_from_numpy
from pydem_tpu_torch.ops import uca_block as t_ub
from pydem_tpu_torch.parallel import sharded as t_sharded
from pydem_tpu_torch.parallel.mesh import make_mesh
from test_torch_uca_block import _cone_state, _pit_inputs, _torch

torch.set_num_threads(1)

# canvases around the rules' edges: under 256, 256, mixed, over 256
SHAPES = [(32, 32), (100, 300), (255, 255), (255, 600), (256, 256),
          (300, 257), (512, 256), (384, 640)]


class _Chose(Exception):
    """Raised by a patched solver with the block size it was handed."""


def _chooser(position):
    def fake(*args, **kw):
        raise _Chose(kw["B"] if "B" in kw else args[position])
    return fake


def _chosen(fn, *args, **kw):
    with pytest.raises(_Chose) as got:
        fn(*args, **kw)
    return got.value.args[0]


@pytest.mark.parametrize("shape", [(32, 32), (255, 600), (256, 256),
                                   (300, 257)])
def test_terrain_step_takes_the_jax_block_size(shape, monkeypatch):
    """``terrain_step(uca_solver="blocked")`` hands its solver the B of the
    JAX ``terrain_step`` on the same canvas (both solvers patched to report
    it), and ``_block_size`` is that rule."""
    n, m = shape
    elev = np.random.RandomState(n + m).uniform(0, 10, shape)
    ones = [np.ones(n - 1)] * 2 + [np.ones(n)] * 2
    monkeypatch.setattr(j_ub, "accumulate_blocked_gs", _chooser(2))
    monkeypatch.setattr(t_ub, "accumulate_blocked_gs", _chooser(2))
    with jax.disable_jit():
        want = _chosen(j_sharded.terrain_step, jnp.asarray(elev),
                       *map(jnp.asarray, ones), uca_solver="blocked")
    s = state_from_numpy(dict(elev=elev, dX=ones[0], dY=ones[1],
                              dX2=ones[2], dY2=ones[3]), "cpu",
                         torch.float64)
    got = _chosen(t_sharded.terrain_step,
                  *[s[k] for k in ("elev", "dX", "dY", "dX2", "dY2")],
                  uca_solver="blocked")
    assert got == want == t_sharded._block_size(n, m)
    assert want == (256 if min(n, m) >= 256 else 128)


@pytest.mark.parametrize("pits", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_dem_processor_takes_the_jax_block_size(shape, pits, monkeypatch):
    """The blocked solve of ``DEMProcessor`` (``_solve_uca``, with and
    without pit links, ``uca_block_size=None``) hands its solver the JAX
    ``DEMProcessor``'s B; an explicit ``block_size`` passes through."""
    n, m = shape
    base, W = np.ones(shape), np.zeros((8,) + shape)
    links = (np.array([0]), np.array([n * m - 1]), np.array([1.0])) \
        if pits else (None,) * 3
    for name in ("accumulate_blocked_gs", "accumulate_blocked_pits_gs"):
        for module in (j_ub, t_ub):  # both hand B as a keyword
            monkeypatch.setattr(module, name, _chooser(None))
    assert t_api.DEMProcessor.uca_block_size is None
    assert j_api.DEMProcessor.uca_block_size is None
    for block_size in (None, 64):
        want = _chosen(j_api._solve_uca, jnp.asarray(base), jnp.asarray(W),
                       shape, *(None if a is None else jnp.asarray(a)
                                for a in links), 100, 4, "blocked",
                       block_size, True)
        got = _chosen(t_api._solve_uca, torch.from_numpy(base),
                      torch.from_numpy(W), shape,
                      *(None if a is None else torch.from_numpy(a)
                        for a in links), 100, 4, "blocked", block_size)
        assert got == want == (block_size or t_sharded._block_size(n, m))


@pytest.mark.parametrize("S", [16, 64, 100, 128, 192, 256, 384, 512, 2048])
def test_engine_takes_the_jax_card_block_size(S):
    """The engine's rule on a GPU is the JAX engine's on a TPU (``interpret
    =False``): 256, or 128 under 256, and both raise where B does not divide
    the super-block; on the CPU the port keeps 64, or 16."""
    n = 64
    args = (None, (n, n), np.ones(n - 1), np.ones(n - 1), np.ones(n),
            np.ones(n))
    try:
        want = j_ooc.OutOfCoreEngine(*args, superblock=S,
                                     interpret=False).B
    except ValueError:
        with pytest.raises(ValueError, match="multiple"):
            t_ooc._engine_block_size(S, "cuda")
        want = None
    if want is not None:
        assert t_ooc._engine_block_size(S, torch.device("cuda", 0)) == want
    if S % 16 == 0:
        eng = t_ooc.OutOfCoreEngine(*args, superblock=S, device="cpu")
        assert eng.B == (64 if S % 64 == 0 else 16)


def test_shard_block_size_is_the_jax_rule_but_32_and_8():
    """``_shard_block_size`` == the JAX function's at every shard size, 32
    and 8 included (the kernels are built for every B the JAX function
    takes)."""
    sizes = [8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 512,
             768, 1024, 1536, 4096, 12288]
    for a in sizes:
        for b in sizes:
            want = j_sharded._shard_block_size(a, b)
            got = t_sharded._shard_block_size(a, b)
            assert got == want, (a, b)


def _recorded(module, name, seen):
    """``module.name`` wrapped to append the B it is handed to ``seen``."""
    fn = getattr(module, name)

    @functools.wraps(fn)  # with its attributes (the solver's counters)
    def wrapper(*args, **kw):
        seen.append(kw["B"] if "B" in kw else args[3])
        return fn(*args, **kw)
    return wrapper


# 2x2 meshes whose shards 32 (96²) or 8 (40²) divides and no larger B does
MESH_CASES = [(192, 32), (80, 8)]


@pytest.mark.parametrize("n,B", MESH_CASES)
def test_accumulate_sharded_at_32_and_8_returns_jax_rounds(n, B,
                                                           monkeypatch):
    """``accumulate_sharded`` on a 2x2 mesh takes the JAX function's B (32
    on 96² shards, 8 on 40²) and returns its rounds, values to 10
    decimals."""
    from test_torch_sharded import _planes

    W, base = _planes(13, n, n)
    jmesh = j_sharded.make_mesh(jax.devices()[:4], (2, 2))
    tmesh = make_mesh([torch.device("cpu")] * 4, (2, 2))
    jseen, tseen = [], []
    monkeypatch.setattr(j_ub, "gs_round_oriented",
                        _recorded(j_ub, "gs_round_oriented", jseen))
    monkeypatch.setattr(t_sharded, "_blocked_shards",
                        _recorded(t_sharded, "_blocked_shards", tseen))
    want, want_rounds = j_sharded.accumulate_sharded(
        jnp.asarray(base.numpy()), jnp.asarray(W.numpy()), jmesh,
        interpret=True)
    got, rounds = t_sharded.accumulate_sharded(base, W, tmesh)
    assert set(jseen) == set(tseen) == {B}
    assert rounds == int(want_rounds) > 1
    np.testing.assert_array_almost_equal(got.assemble().numpy(),
                                         np.asarray(want), decimal=10)


@pytest.mark.parametrize("n,B", MESH_CASES)
def test_run_sharded_at_32_and_8_returns_jax_rounds(n, B, monkeypatch):
    """``run_sharded(uca_solver="blocked")`` on a 2x2 mesh takes the JAX
    function's B and returns its rounds (``uca_sweeps``), every output to
    10 decimals with equal NaN patterns (the JAX function jitted, its
    blocked solver in interpret mode)."""
    elev, _a, _u = j_fixtures.get_test_case(24, n)
    elev = np.ascontiguousarray(np.asarray(elev, "float64")[:n, :n])
    rows = (np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n))
    jmesh = j_sharded.make_mesh(jax.devices()[:4], (2, 2))
    tmesh = make_mesh([torch.device("cpu")] * 4, (2, 2))
    jseen, tseen = [], []
    monkeypatch.setattr(j_ub, "gs_round_oriented",
                        _recorded(j_ub, "gs_round_oriented", jseen))
    monkeypatch.setattr(t_sharded, "_blocked_shards",
                        _recorded(t_sharded, "_blocked_shards", tseen))
    want = jax.jit(functools.partial(j_sharded.run_sharded, mesh=jmesh,
                           uca_solver="blocked"))(elev, *rows)
    got = t_sharded.run_sharded(elev, *rows, mesh=tmesh, uca_solver="blocked")
    assert set(jseen) == set(tseen) == {B}
    assert got["uca_sweeps"] == int(want["uca_sweeps"]) > 1
    for key in ("mag", "direction", "flats", "uca", "twi"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), key)
        np.testing.assert_array_almost_equal(
            np.nan_to_num(g), np.nan_to_num(w), decimal=10, err_msg=key)


@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (1024, 512),
                                   (300, 600)])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)])
def test_mesh_solvers_take_the_jax_block_size(shape, mesh_shape,
                                              monkeypatch):
    """``sharded_uca`` and ``accumulate_sharded`` hand their solvers the
    JAX functions' B on the same mesh shape (the JAX ones on a TPU,
    ``interpret=False``): 256, or 128 for shards under 256, and the shard
    rule."""
    n, m = shape
    gy, gx = mesh_shape
    base, W = np.ones(shape), np.zeros((8,) + shape)
    jmesh = j_sharded.make_mesh(jax.devices()[: gy * gx], mesh_shape)
    tmesh = make_mesh([torch.device("cpu")] * (gy * gx), mesh_shape)
    monkeypatch.setattr(j_sharded, "accumulate_sharded", _chooser(3))
    monkeypatch.setattr(t_sharded, "_solve_shards", _chooser(5))
    want = _chosen(j_sharded.sharded_uca, jnp.asarray(base), jnp.asarray(W),
                   jmesh, uca_solver="blocked", interpret=False)
    got = _chosen(t_sharded.sharded_uca, torch.from_numpy(base),
                  torch.from_numpy(W), tmesh, uca_solver="blocked")
    assert got == want
    monkeypatch.undo()
    if n % gy or m % gx:
        return
    monkeypatch.setattr(t_sharded, "_blocked_shards", _chooser(3))
    want = j_sharded._shard_block_size(n // gy, m // gx)
    args = (torch.from_numpy(base), torch.from_numpy(W), tmesh)
    if want is None:  # the JAX function raises too
        with pytest.raises(ValueError, match="too small"):
            t_sharded.accumulate_sharded(*args)
    else:
        assert _chosen(t_sharded.accumulate_sharded, *args) == want


def _solver_case(case):
    """``(W, base, links)`` of a case: the n² cone, or fixture 13 at 128²
    with its pit links left in."""
    if case.startswith("cone"):
        W, base = _cone_state(int(case.split()[1]))
        return W, base, []
    W, base, *links = _pit_inputs(13, 128)
    assert len(links[0])
    return W, base, links


@pytest.mark.parametrize("solver,case,B", [
    ("gs", "cone 256", 128), ("blocked", "cone 256", 128),
    ("pits_gs", "fixture 13", 128), ("pits", "fixture 13", 128),
    ("gs", "cone 512", 256), ("blocked", "cone 512", 256)])
def test_solvers_return_jax_rounds_at_tpu_block_sizes(solver, case, B):
    """``accumulate_blocked_gs``, ``accumulate_blocked_pits_gs`` and K2's
    ``accumulate_blocked`` and ``accumulate_blocked_pits`` at the TPU's
    B = 128 and 256 (their default ``inner_max``, 2B + 4) return exactly
    the JAX solvers' rounds, values to 10 decimals."""
    W, base, links = _solver_case(case)
    name = "accumulate_blocked" if solver == "blocked" \
        else "accumulate_blocked_%s" % solver
    want, want_rounds = getattr(j_ub, name)(
        base, W, *(jnp.asarray(a) for a in links), B=B, interpret=True)
    got, rounds = getattr(t_ub, name)(*_torch(base, W, *links), B=B)
    assert rounds == int(want_rounds) >= 1
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


def test_solvers_default_to_the_tpu_block_size():
    """The four solvers default to the JAX solvers' B = 256: a canvas that
    256 does not divide is refused, one it divides runs."""
    W, base = _cone_state(128)
    for fn in (t_ub.accumulate_blocked_gs, t_ub.accumulate_blocked):
        with pytest.raises(ValueError, match="block size 256"):
            fn(*_torch(base, W))
    links = _torch(np.zeros(0, np.int64), np.zeros(0, np.int64),
                   np.zeros(0))
    for fn in (t_ub.accumulate_blocked_pits_gs, t_ub.accumulate_blocked_pits):
        with pytest.raises(ValueError, match="block size 256"):
            fn(*_torch(base, W), *links)
