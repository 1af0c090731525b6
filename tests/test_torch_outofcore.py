"""pydem_tpu_torch.outofcore on the CPU (float64): the cases of
``tests/test_outofcore.py`` on the port.

Each engine case runs the same numpy input (``fixtures.get_test_case``)
through the port's ``OutOfCoreEngine(device="cpu")``, the port's in-core
``DEMProcessor(device="cpu")`` and the JAX package's ``OutOfCoreEngine``,
and compares store arrays.  On the CPU the port's K1 ring round is its plain
version; the JAX engine reaches its Pallas kernel in interpret mode, as its
own tests run it.

Tolerances: ``elev`` and ``flats`` exact, NaN patterns equal, ``slope``,
``aspect``, ``uca`` (unit pixels, so in pixels) and ``twi`` ``decimal=10``;
the port's two regimes, and two runs of one regime, bitwise.

The JAX engine runs jitted, as its own tests run it.  Jitted on the CPU, XLA
contracts an FMA in the facet sweep, which can flip a near-tie facet; on
these fixtures, through the engine's windows, it does not (the comparison
with the JAX store would show it at once).
"""
import os

import numpy as np
import pytest
import torch

from pydem_tpu import fixtures as j_fixtures
from pydem_tpu.io.store import ArrayStore as JArrayStore
from pydem_tpu.outofcore import OutOfCoreEngine as JEngine
from pydem_tpu.outofcore import _sb_uca_solve as j_sb_uca_solve
from pydem_tpu_torch import fixtures, outofcore
from pydem_tpu_torch.api import DEMProcessor
from pydem_tpu_torch.io.store import ArrayStore
from pydem_tpu_torch.outofcore import OutOfCoreEngine, _sb_uca_solve

torch.set_num_threads(1)

FIELDS = ("elev", "slope", "aspect", "uca", "twi")
NO_COND = dict(fill_flats=False, drain_pits_path=False)
# name -> (fixture, size, rows kept, superblock, margin, options, budget)
CASES = {
    "cone_partial_blocks": (33, 48, 40, 16, 64, {}, None),
    "small_margin": (33, 96, 96, 32, 24, {}, None),
    "pit_links_cross_blocks": (13, 48, 48, 16, 64, NO_COND, None),
    "masked_sea": (24, 48, 48, 16, 64, {}, None),
    "streaming_with_frontier": (13, 48, 48, 16, 64, {}, 0),
    "streaming_pit_free": (33, 48, 48, 16, 64, {}, 0),
    "streaming_6x6_blocks": (33, 96, 96, 16, 24, {}, 0),
}


def _case_elev(name):
    num, size, rows = CASES[name][:3]
    elev, _a, _u = fixtures.get_test_case(num, size)
    j_elev, _a, _u = j_fixtures.get_test_case(num, size)
    np.testing.assert_array_equal(elev, j_elev)
    return elev[:rows]


def _engine(cls, store_cls, path, elev, S=16, margin=64, resume=False,
            budget=None, **kwargs):
    store = store_cls(str(path))
    store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                 fill=np.nan, overwrite=True)
    store.write_window("elev_src", elev, (0, 0))
    n = elev.shape[0]
    extra = {"device": "cpu"} if cls is OutOfCoreEngine else {}
    eng = cls(store, elev.shape, np.ones(n - 1), np.ones(n - 1), np.ones(n),
              np.ones(n), dem_proc_kwargs=kwargs, superblock=S, margin=margin,
              resume=resume, device_cache_bytes=budget, **extra)
    return store, eng


def _t_engine(path, elev, **kw):
    return _engine(OutOfCoreEngine, ArrayStore, path, elev, **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engine's store and engine, one run per case."""
    runs = {}

    def get(name):
        if name not in runs:
            _num, _size, _rows, S, margin, opts, budget = CASES[name]
            store, eng = _engine(
                JEngine, JArrayStore,
                tmp_path_factory.mktemp("jax_" + name) / "ooc.zarr",
                _case_elev(name), S=S, margin=margin, budget=budget, **opts)
            eng.run()
            runs[name] = (store, eng)
        return runs[name]

    return get


def _assert_fields(got, want, fields, what):
    for key in fields:
        a = np.asarray(want[key], "float64")
        b = np.asarray(got[key], "float64")
        assert (np.isnan(a) == np.isnan(b)).all(), (what, key)
        if key == "elev":
            np.testing.assert_array_equal(a, b, err_msg="%s elev" % what)
        else:
            np.testing.assert_array_almost_equal(
                np.nan_to_num(a), np.nan_to_num(b), decimal=10,
                err_msg="%s %s" % (what, key))


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_in_core_and_jax(tmp_path, jax_runs, name):
    _num, _size, _rows, S, margin, opts, budget = CASES[name]
    elev = _case_elev(name)
    store, eng = _t_engine(tmp_path / "ooc.zarr", elev, S=S, margin=margin,
                           budget=budget, **opts)
    assert eng._fits_device_resident() == (budget is None)
    eng.run()
    assert eng.uca_rounds >= 1
    if budget == 0:
        assert eng.uca_visits >= eng.nbi * eng.nbj
    if name == "streaming_6x6_blocks":
        assert eng.uca_skipped > 0  # the frontier skipped some visits

    n = elev.shape[0]
    dp = DEMProcessor(elev=elev.copy(), dX=np.ones(n - 1), dY=np.ones(n - 1),
                      dX2=np.ones(n), dY2=np.ones(n), device="cpu", **opts)
    dp.calc_twi()
    # a seam through a flat wider than the margin may condition differently
    # from the global pass (module docstring); as in the JAX package's tests
    # the masked case is held on uca, the pit cases on uca and twi
    in_core = {"masked_sea": ("uca",),
               "pit_links_cross_blocks": ("uca", "twi")}.get(name, FIELDS)
    _assert_fields(store, {"slope": dp.mag, "aspect": dp.direction,
                           "uca": dp.uca, "twi": dp.twi, "elev": dp.elev},
                   in_core, "in-core")

    j_store, j_eng = jax_runs(name)
    _assert_fields(store, j_store, FIELDS, "JAX engine")
    np.testing.assert_array_equal(store["flats"], j_store["flats"])
    for a, b in zip(eng._links, j_eng._links):
        np.testing.assert_array_almost_equal(a, b, decimal=12)
    if name == "pit_links_cross_blocks":
        assert len(eng._links[0]) > 0  # the fixture actually has pit links


@pytest.mark.parametrize("name", ["streaming_with_frontier",
                                  "streaming_pit_free", "cone_partial_blocks"])
def test_engine_rounds_equal_jax(tmp_path, jax_runs, name):
    """At the JAX engine's K1 block (B = 8 in interpret mode) the port's
    engine takes the JAX engine's outer rounds, streamed (each visit's
    rounds in the TPU's order from the outer round's orientation) and
    device-resident, with the same uca to 10 decimals."""
    _num, _size, _rows, S, margin, opts, budget = CASES[name]
    store, eng = _t_engine(tmp_path / "ooc.zarr", _case_elev(name), S=S,
                           margin=margin, budget=budget, **opts)
    eng.B = 8
    eng.run()
    j_store, j_eng = jax_runs(name)
    assert eng.uca_rounds == j_eng.uca_rounds
    _assert_fields(store, j_store, ("uca",), "JAX engine")


def test_engine_resume_is_idempotent(tmp_path):
    elev = _case_elev("cone_partial_blocks")
    store, eng = _t_engine(tmp_path / "ooc.zarr", elev)
    eng.run()
    uca0 = store["uca"]
    store2, eng2 = _t_engine(tmp_path / "ooc.zarr", elev, resume=True)
    eng2.condition = None  # a stage that ran again would raise
    eng2.run()
    assert eng2.uca_rounds == eng.uca_rounds
    np.testing.assert_array_equal(uca0, store2["uca"])


def test_streaming_resume_continues(tmp_path):
    """A streaming run cut after its UCA stage resumes from the stored
    state and round count and ends at the same arrays."""
    elev = _case_elev("streaming_with_frontier")
    s1, e1 = _t_engine(tmp_path / "a.zarr", elev, budget=0)
    e1.run()
    s2, e2 = _t_engine(tmp_path / "b.zarr", elev, budget=0)
    e2.condition(), e2.slope_direction(), e2.pit_links(), e2.uca()
    s3, e3 = _t_engine(tmp_path / "b.zarr", elev, budget=0, resume=True)
    e3.run()
    assert e3.uca_rounds == e2.uca_rounds + 1  # one still round more
    for key in ("uca", "twi"):
        np.testing.assert_array_equal(s1[key], s3[key])


def test_engine_device_vs_streaming_identical(tmp_path, monkeypatch):
    """The device-resident regime and the streaming rounds reach the same
    fixed point bitwise on a pit-free canvas; the budget is steered by the
    environment variable, as the JAX package's test does."""
    elev = _case_elev("cone_partial_blocks")
    s1, e1 = _t_engine(tmp_path / "a.zarr", elev)
    assert e1._fits_device_resident()
    e1.run()
    monkeypatch.setenv("PYDEM_OOC_DEVICE_CACHE", "0")
    s2, e2 = _t_engine(tmp_path / "b.zarr", elev)
    assert e2.device_cache_bytes == 0 and not e2._fits_device_resident()
    e2.run()
    assert len(e1._links[0]) == len(e2._links[0]) == 0
    for key in ("slope", "aspect", "flats", "uca", "twi"):
        np.testing.assert_array_equal(s1[key], s2[key], err_msg=key)


def test_streaming_is_deterministic(tmp_path):
    """Two streaming runs (pit links, frontier, the IO thread) give bitwise
    equal arrays and equal round and visit counts."""
    elev = _case_elev("streaming_with_frontier")
    runs = []
    for tag in "ab":
        store, eng = _t_engine(tmp_path / (tag + ".zarr"), elev, budget=0)
        eng.run()
        runs.append((store["uca"], store["twi"], eng.uca_rounds,
                     eng.uca_visits, eng.uca_skipped))
    a, b = runs
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]


def test_streaming_cache_budget_does_not_change_result(tmp_path):
    """With room for the per-block static planes but not for the canvas the
    visits reuse cached weights; the arrays are those of the uncached run."""
    elev = _case_elev("streaming_with_frontier")
    s0, e0 = _t_engine(tmp_path / "a.zarr", elev, budget=0)
    e0.run()
    n, m = elev.shape
    budget = outofcore._DEVICE_RESIDENT_PLANES * n * m * 8 - 1
    s1, e1 = _t_engine(tmp_path / "b.zarr", elev, budget=budget)
    assert not e1._fits_device_resident()
    e1.run()
    np.testing.assert_array_equal(s0["uca"], s1["uca"])
    assert (e0.uca_rounds, e0.uca_visits) == (e1.uca_rounds, e1.uca_visits)


@pytest.mark.parametrize("o0", range(4))
@pytest.mark.parametrize("corner", [False, True])
def test_sb_uca_solve_matches_jax(corner, o0):
    """One super-block visit on the same windows, its first round at
    orientation ``o0`` (the engine's outer round): the port's ring rounds
    in the TPU's order (plain, float64) against the JAX function (Pallas in
    interpret mode) at the same B = 8, equal rounds and changed flag,
    values to 10 decimals."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    n, S, B = 64, 32, 8
    elev, _a, _u = fixtures.get_test_case(33, n)
    one = np.ones(n)
    dp = DEMProcessor(elev=elev, dX=one[1:], dY=one[1:], dX2=one, dY2=one,
                      device="cpu", **NO_COND)
    dp.calc_slopes_directions()
    i0 = j0 = 0 if corner else 16

    def win(a, fill):
        p = np.pad(np.asarray(a, "float64"), 1, constant_values=fill)
        return p[i0: i0 + S + 2, j0: j0 + S + 2]

    x = np.ones((n, n)) + rng.rand(n, n)
    x_win = win(x, np.nan)
    e_win, d_win = win(dp.elev, np.nan), win(dp.direction, np.nan)
    f_win = np.pad(dp.flats, 1)[i0: i0 + S + 2, j0: j0 + S + 2]
    theta = np.full(S + 2, np.arctan2(1.0, 1.0))
    base = np.ones((S, S))
    caps = dict(B=B, inner_max=2 * B + 4, max_rounds=4 * (S // B) + 8)

    out, chg, rounds = _sb_uca_solve(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (x_win, e_win, d_win, f_win, theta, base)), o0, **caps)
    j_out, j_chg, j_rounds = j_sb_uca_solve(
        *(jnp.asarray(a) for a in (x_win, e_win, d_win, f_win, theta, base)),
        o0, interpret=True, **caps)
    assert rounds == int(j_rounds) and bool(chg) == bool(j_chg)
    assert rounds > 1
    np.testing.assert_array_almost_equal(out.numpy(), np.asarray(j_out),
                                         decimal=10)


def test_engine_argument_errors(tmp_path):
    elev = _case_elev("cone_partial_blocks")
    with pytest.raises(TypeError, match="Mesh"):
        OutOfCoreEngine(ArrayStore(str(tmp_path / "b.zarr")), elev.shape,
                        1, 1, 1, 1, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="multiple of the kernel block"):
        _t_engine(tmp_path / "c.zarr", elev, S=24)
    with pytest.raises(NotImplementedError, match="deprecated drain"):
        _t_engine(tmp_path / "d.zarr", elev, drain_flats=True)
    # block size: 64 where the super-block is a multiple of 64, else 16
    assert _t_engine(tmp_path / "e.zarr", elev, S=128)[1].B == 64
    assert _t_engine(tmp_path / "f.zarr", elev, S=96)[1].B == 16
    assert _t_engine(tmp_path / "g.zarr", elev, S=48)[1].B == 16


def test_default_device_is_the_card(tmp_path):
    """Without ``device`` the engine runs on the GPU and raises without one;
    it never moves to the CPU by itself."""
    import inspect

    assert (inspect.signature(OutOfCoreEngine.__init__).parameters["device"]
            .default == "cuda")
    elev = _case_elev("cone_partial_blocks")
    store = ArrayStore(str(tmp_path / "a.zarr"))
    n = elev.shape[0]
    args = (store, elev.shape, np.ones(n - 1), np.ones(n - 1), np.ones(n),
            np.ones(n))
    if torch.cuda.is_available():
        assert OutOfCoreEngine(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            OutOfCoreEngine(*args)
    eng = OutOfCoreEngine(*args, device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng._work_dtype == "float64"


def test_device_budget(monkeypatch):
    """The environment variable overrides the budget; on the CPU it is the
    4 GiB constant."""
    monkeypatch.delenv("PYDEM_OOC_DEVICE_CACHE", raising=False)
    assert outofcore._default_device_cache("cpu") == 4 << 30
    monkeypatch.setenv("PYDEM_OOC_DEVICE_CACHE", "12345")
    assert outofcore._default_device_cache("cpu") == 12345
    assert outofcore._default_device_cache("cuda") == 12345


def test_port_imports_no_jax():
    """No module of the port, nor the chip script, imports jax or the JAX
    package."""
    import re

    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(root, "pydem_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    pat = re.compile(r"^\s*(import|from)\s+(jax|pydem_tpu)(\.|\s|$)", re.M)
    for fn in files:
        with open(fn) as f:
            assert not pat.search(f.read()), fn


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("name", ["cone_partial_blocks",
                                  "pit_links_cross_blocks"])
def test_engine_mesh_route_equals_single_device(tmp_path, name, shape):
    """OutOfCoreEngine(mesh=...) on CPU shards == the engine on one device
    over a 1×1 mesh, bitwise, in the rounds of the mesh's shape (and the
    mesh-less engine: see :func:`_against_meshless`): the device-resident
    UCA stage solves on the shards.  A canvas the mesh divides takes the fused pass (40×48 over 2×2
    and 2×4, shards that are not whole K1 blocks); the others (48×45) pad
    to the mesh with NaN elevation and take the staged stages."""
    from pydem_tpu_torch.parallel.mesh import make_mesh

    _num, _size, _rows, S, margin, opts, _budget = CASES[name]
    elev = _case_elev(name)[:, :45 if name.startswith("pit") else None]
    mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
    s0, e0 = _one_shard_engine(tmp_path / "one.zarr", elev, S=S,
                               margin=margin, **opts)
    e0.run()
    store = ArrayStore(str(tmp_path / "mesh.zarr"))
    store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                 fill=np.nan, overwrite=True)
    store.write_window("elev_src", elev, (0, 0))
    n = elev.shape[0]
    e1 = OutOfCoreEngine(store, elev.shape, np.ones(n - 1), np.ones(n - 1),
                         np.ones(n), np.ones(n), dem_proc_kwargs=opts,
                         superblock=S, margin=margin, mesh=mesh,
                         device="cpu")
    np_, mp_, got_mesh = e1._padded_dims()
    assert got_mesh is mesh and np_ % shape[0] == 0 and mp_ % shape[1] == 0
    assert e1._fits_device_resident()  # one distinct device: its budget
    calls = []
    fused = e1._run_fused_device
    e1._run_fused_device = lambda: calls.append(1) or fused()
    e1.run()
    assert calls == ([1] if (np_, mp_) == elev.shape else [])
    assert len(e1._links[0]) == len(e0._links[0])
    for key in ("slope", "aspect", "flats", "uca", "twi"):
        np.testing.assert_array_equal(store[key], s0[key], err_msg=key)
    _against_meshless(tmp_path / "meshless.zarr", elev, store, e1, (s0, e0),
                      S=S, margin=margin, **opts)


@pytest.mark.parametrize("shape", [(2, 2), (3, 2)])
def test_mesh_does_not_enlarge_the_device_budget(tmp_path, shape):
    """The CPU's devices are one memory, so a mesh whose cells name
    distinct CPU devices admits no larger canvas than the CPU alone; the
    canvas counted is the one padded to the mesh (40×48 over 3×2 is
    42×48)."""
    from pydem_tpu_torch.parallel.mesh import make_mesh

    elev = _case_elev("cone_partial_blocks")
    k = shape[0] * shape[1]
    mesh = make_mesh([torch.device("cpu", i) for i in range(k)], shape)
    assert mesh.distinct_devices == k
    n, m = elev.shape
    np_, mp_ = n + (-n) % shape[0], m + (-m) % shape[1]
    need = outofcore._DEVICE_RESIDENT_PLANES * np_ * mp_ * 8
    store = ArrayStore(str(tmp_path / "a.zarr"))
    # one byte short for one device, though k such budgets would hold it
    for budget, fits in ((need, True), (need - 1, False)):
        eng = OutOfCoreEngine(store, elev.shape, np.ones(n - 1),
                              np.ones(n - 1), np.ones(n), np.ones(n),
                              mesh=mesh, device_cache_bytes=budget,
                              device="cpu")
        assert eng._padded_dims()[:2] == (np_, mp_)
        assert eng._fits_device_resident() == fits, budget


# -- the per-shard device-resident path -------------------------------------

def _mesh_engine(path, elev, mesh, S=16, margin=64, **opts):
    store = ArrayStore(str(path))
    store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                 fill=np.nan, overwrite=True)
    store.write_window("elev_src", elev, (0, 0))
    n = elev.shape[0]
    eng = OutOfCoreEngine(store, elev.shape, np.ones(n - 1), np.ones(n - 1),
                          np.ones(n), np.ones(n), dem_proc_kwargs=opts,
                          superblock=S, margin=margin, mesh=mesh,
                          device="cpu")
    return store, eng


def _one_shard_engine(path, elev, S=16, margin=64, **opts):
    """The engine over a 1×1 mesh: its solve is the sharded solver's on one
    shard, the rounds of the mesh-less engine's in-core solve."""
    from pydem_tpu_torch.parallel.mesh import make_mesh

    return _mesh_engine(path, elev, make_mesh([torch.device("cpu")], (1, 1)),
                        S=S, margin=margin, **opts)


def _against_meshless(path, elev, store, eng, one, S=16, margin=64, **opts):
    """A mesh run (``store``, ``eng``) and the 1×1-mesh run ``one`` (its
    store and engine) against the mesh-less engine, whose in-core solve
    runs the TPU's order on the whole canvas: the 1×1 mesh equals it bit
    for bit, in equal rounds on these fixtures (the in-core solver's
    frontier could change the count elsewhere); the mesh reaches the same
    fixed point, bit for bit, in the rounds of its own shape (each shard
    runs its own sequential grid against a ring frozen at the round's
    start, as the JAX solver's shards do)."""
    s_gs, e_gs = _t_engine(str(path) + ".gs", elev, S=S, margin=margin,
                           **opts)
    e_gs.run()
    s_one, e_one = one
    assert e_one.uca_rounds == e_gs.uca_rounds
    for key in ("slope", "aspect", "flats", "uca", "twi"):
        np.testing.assert_array_equal(s_one[key], s_gs[key], err_msg=key)
        np.testing.assert_array_equal(store[key], s_gs[key], err_msg=key)
    assert eng.uca_rounds >= 1


# fixture, options: a pit-free cone, and terrain with pit links
PER_SHARD = {"cone": (33, {}), "pit_links": (13, NO_COND)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", sorted(PER_SHARD))
def test_engine_per_shard_fused_equals_meshless(tmp_path, name, shape):
    """A 64² canvas over 1×2 and 2×2 CPU shards of whole K1 blocks takes
    the fused pass shard by shard (slope, weights, the sharded solve,
    finalize per shard) and equals the fused pass over a 1×1 mesh bitwise,
    links included, in the rounds of its own shape, and the mesh-less fused
    pass (see :func:`_against_meshless`)."""
    from pydem_tpu_torch.parallel.mesh import make_mesh

    num, opts = PER_SHARD[name]
    elev, _a, _u = fixtures.get_test_case(num, 64)
    s0, e0 = _one_shard_engine(tmp_path / "one.zarr", elev, **opts)
    e0.run()
    mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
    store, eng = _mesh_engine(tmp_path / "mesh.zarr", elev, mesh, **opts)
    assert eng._padded_dims()[:2] == elev.shape  # no pad: the fused pass
    assert eng._fits_device_resident()
    calls = []
    fused = eng._run_fused_device
    eng._run_fused_device = lambda: calls.append(1) or fused()
    eng.run()
    assert calls == [1]
    assert len(eng._links[0]) == len(e0._links[0])
    if name == "pit_links":
        assert len(eng._links[0]) > 0
    for key in ("slope", "aspect", "flats", "uca_state", "uca", "twi"):
        np.testing.assert_array_equal(store[key], s0[key], err_msg=key)
    _against_meshless(tmp_path / "meshless.zarr", elev, store, eng,
                      (s0, e0), **opts)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", sorted(PER_SHARD))
def test_engine_divided_unaligned_canvas_takes_fused_pass(tmp_path, name,
                                                          shape):
    """A 48×40 canvas over 1×2 and 2×2 CPU shards (48×20, 24×20: the mesh
    divides it, K1's 16² blocks do not) keeps the fused pass; its solve
    runs on shards of the canvas padded to whole blocks, and the result
    equals the fused pass over a 1×1 mesh bitwise, links included, in the
    rounds of its own shape, and the mesh-less fused pass (see
    :func:`_against_meshless`)."""
    from pydem_tpu_torch.parallel.mesh import make_mesh

    num, opts = PER_SHARD[name]
    elev, _a, _u = fixtures.get_test_case(num, 64)
    elev = np.ascontiguousarray(elev[:48, :40])
    s0, e0 = _one_shard_engine(tmp_path / "one.zarr", elev, **opts)
    e0.run()
    mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
    store, eng = _mesh_engine(tmp_path / "mesh.zarr", elev, mesh, **opts)
    assert eng._padded_dims()[:2] == elev.shape
    assert eng._padded_dims(solve=True)[:2] == (64 if shape[0] == 2 else 48,
                                                 64)
    calls = []
    fused = eng._run_fused_device
    eng._run_fused_device = lambda: calls.append(1) or fused()
    eng.run()
    assert calls == [1]
    assert len(eng._links[0]) == len(e0._links[0])
    for key in ("slope", "aspect", "flats", "uca_state", "uca", "twi"):
        np.testing.assert_array_equal(store[key], s0[key], err_msg=key)
    _against_meshless(tmp_path / "meshless.zarr", elev, store, eng,
                      (s0, e0), **opts)


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    """The JAX engine over a 2×4 mesh of the virtual CPU devices, one run
    per case of PER_SHARD at 64², S = 16.  Its fused slope program runs op
    by op (``jax.disable_jit()``): jitted on the CPU, XLA contracts an FMA
    in the facet sweep and flips two near-tie facets of fixture 33 here
    (ROADMAP queue 3)."""
    import jax

    from pydem_tpu import outofcore as j_outofcore
    from pydem_tpu.parallel.sharded import make_mesh as j_make_mesh

    runs = {}
    jitted = j_outofcore._slope_program

    def op_by_op(*args):
        with jax.disable_jit():
            return jitted(*args)

    def get(name):
        if name not in runs:
            num, opts = PER_SHARD[name]
            elev, _a, _u = j_fixtures.get_test_case(num, 64)
            store, eng = _engine(JEngine, JArrayStore,
                                 tmp_path_factory.mktemp("jm_" + name)
                                 / "ooc.zarr", elev, **opts)
            eng.mesh = j_make_mesh(jax.devices()[:8], shape=(2, 4))
            j_outofcore._slope_program = op_by_op
            try:
                eng.run()
            finally:
                j_outofcore._slope_program = jitted
            runs[name] = store, eng
        return runs[name]

    return get


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("name", sorted(PER_SHARD))
def test_engine_per_shard_matches_jax_mesh(tmp_path, jax_mesh_runs, name,
                                           shape):
    """The port's engine over CPU shards against the JAX engine over the
    8-virtual-device mesh (its canvases sharded under GSPMD), with and
    without pit links, within this file's tolerances, both at the JAX
    engine's B = 8; over the JAX mesh's 2×4 shape, in its rounds."""
    import jax

    from pydem_tpu_torch.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    num, opts = PER_SHARD[name]
    elev, _a, _u = fixtures.get_test_case(num, 64)
    mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
    store, eng = _mesh_engine(tmp_path / "mesh.zarr", elev, mesh, **opts)
    eng.B = 8  # the JAX engine's K1 block in interpret mode
    eng.run()
    j_store, j_eng = jax_mesh_runs(name)
    if shape == (2, 4):  # the JAX mesh's shape: its rounds
        assert eng.uca_rounds == j_eng.uca_rounds
    _assert_fields(store, j_store, FIELDS, "JAX engine over a mesh")
    np.testing.assert_array_equal(store["flats"], j_store["flats"])


def _cards(k, shape):
    """A mesh of descriptor-only CUDA devices: cell c on card c % k."""
    from pydem_tpu_torch.parallel.mesh import Mesh

    return Mesh([torch.device("cuda", c % k)
                 for c in range(shape[0] * shape[1])], shape)


@pytest.mark.parametrize("mesh, holds", [
    (None, 1), ("four cards", 4), ("four shards on one card", 1),
    ("two cards, two shards each", 2), ("four CPU cells", 1),
    ("eight shards on four cards", 4)])
def test_fits_device_resident_per_card(mesh, holds):
    """The fit rule counts the planes of the shards each device holds
    against that device's budget: four cards hold four times what one card
    holds, four shards on one card what one card holds, the CPU what it
    holds."""
    from pydem_tpu_torch.parallel.mesh import Mesh

    mesh = {None: None, "four cards": _cards(4, (2, 2)),
            "four shards on one card": _cards(1, (2, 2)),
            "two cards, two shards each": _cards(2, (2, 2)),
            "four CPU cells": Mesh([torch.device("cpu", c)
                                    for c in range(4)], (2, 2)),
            "eight shards on four cards": _cards(4, (2, 4))}[mesh]
    budget = outofcore._DEVICE_RESIDENT_PLANES * 4096 * 4096 * 4
    side = int(4096 * np.sqrt(holds))  # the largest square canvas that fits
    for shape, fits in (((4096, 4096), True), ((side, side), True),
                        ((side, side + 128), False)):
        assert outofcore.fits_device_resident(shape, 4, budget,
                                              mesh) == fits, (shape, fits)


def test_engine_refuses_a_distributed_mesh(tmp_path):
    """Ranks of a distributed mesh would each write the shared store."""
    from pydem_tpu_torch.parallel.mesh import Mesh

    elev = _case_elev("cone_partial_blocks")
    mesh = Mesh([torch.device("cpu")] * 2, (2, 1), distributed=True)
    with pytest.raises(ValueError, match="this process"):
        _mesh_engine(tmp_path / "a.zarr", elev, mesh)
