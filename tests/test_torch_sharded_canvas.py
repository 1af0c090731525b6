"""Sharded results: the mesh functions of pydem_tpu_torch.parallel return
their canvases as ``ShardedCanvas``es, the shards on their cells' devices,
as the JAX functions return arrays laid over the mesh.

``np.asarray`` of each result on the port's 2x2 and 2x4 CPU meshes is held
against the JAX function on a JAX CPU mesh of the same shape (float64; NaN
patterns equal, values to decimal=10, as ``test_torch_sharded.py``), on
canvases that the mesh divides, that it does not (cropped), and whose
shards are not whole K1 blocks (re-cut).  The JAX references are jitted
(the blocked solvers in Pallas interpret mode) on fixtures where the jitted
facet sweep takes no FMA-contracted near tie (24, 5; the solvers take the
port's own planes).  Then: a ``ShardedCanvas`` passed in gives what the
whole canvas gives, and no function assembles a canvas.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import fixtures as j_fixtures
from pydem_tpu.core.flats_device import _flat_mask as j_flat_mask
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch import fixtures
from pydem_tpu_torch.parallel import mesh as mesh_mod
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.parallel.mesh import (ShardedCanvas, layout, make_mesh,
                                           retile, split)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MESHES = [(2, 2), (2, 4)]
STEP_KEYS = ("mag", "direction", "flats", "uca", "twi")


def _mesh(shape):
    return make_mesh([CPU] * (shape[0] * shape[1]), shape)


@lru_cache(maxsize=None)
def _jmesh(shape):
    return j_sharded.make_mesh(jax.devices()[: shape[0] * shape[1]],
                               shape=shape)


def _rows(n):
    return np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n)


def _elev(case, n, m):
    elev, _a, _u = j_fixtures.get_test_case(case, max(n, m))
    return np.ascontiguousarray(np.asarray(elev, "float64")[:n, :m])


def _planes(case=13, n=16, m=32):
    """The port's receiver planes and base of a fixture cut to n × m."""
    elev, _a, _u = fixtures.get_test_case(case, max(n, m))
    elev = torch.from_numpy(np.ascontiguousarray(elev[:n, :m], "float64"))
    _mag, _d, _f, W, base = sharded.terrain_pre(
        elev, *(torch.from_numpy(v) for v in _rows(n)))
    return W, base.contiguous()


def _links(n, m, count=12, seed=4):
    rng = np.random.RandomState(seed)
    dst_i = rng.randint(8, n, count // 4).repeat(4)
    dst = dst_i * m + rng.randint(0, m, count // 4).repeat(4)
    src = (dst_i - rng.randint(2, 8, count)) * m + rng.randint(0, m, count)
    return src, dst, rng.uniform(0, 0.5, count)


def _close(got, want, what=""):
    """NaN patterns equal, values to decimal=10 (bools and ints equal)."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if g.dtype.kind != "f":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    np.testing.assert_array_almost_equal(np.nan_to_num(g), np.nan_to_num(w),
                                         decimal=10, err_msg=what)


def _assert_step(got, want):
    for key in STEP_KEYS:
        assert isinstance(got[key], ShardedCanvas), key
        _close(got[key], want[key], key)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert np.array_equal(a, b)


# -- against the JAX functions on a JAX mesh of the same shape ---------------

@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
@pytest.mark.parametrize("shape", MESHES)
def test_run_sharded_equals_jax_mesh(shape, solver):
    """A 32² canvas of fixture 24 (flats, no-data): 2x2 shards are whole
    16-blocks, 2x4 shards (16×8) are re-cut onto whole blocks."""
    n = 32
    elev = _elev(24, n, n)
    got = sharded.run_sharded(elev, *_rows(n), mesh=_mesh(shape),
                              uca_solver=solver)
    want = jax.jit(partial(j_sharded.run_sharded, mesh=_jmesh(shape),
                           uca_solver=solver))(elev, *_rows(n))
    _assert_step(got, want)


@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
@pytest.mark.parametrize("shape", MESHES)
def test_run_sharded_cropped_equals_jax_mesh(shape, solver):
    """A 31×42 canvas, which neither mesh divides: both packages pad it with
    NaN and crop the outputs; the port keeps the padded shards.  (The JAX
    blocked solver needs whole blocks a shard, so its jacobi run is the
    reference for both solvers: one fixed point.)"""
    n, m = 31, 42
    elev = _elev(5, n, m)
    mesh = _mesh(shape)
    got = sharded.run_sharded(elev, *_rows(n), mesh=mesh, uca_solver=solver)
    want = jax.jit(partial(j_sharded.run_sharded, mesh=_jmesh(shape),
                           uca_solver="jacobi"))(elev, *_rows(n))
    _assert_step(got, want)
    uca = got["uca"]
    assert uca.shape == (n, m) and uca.padded_shape == (
        n + (-n) % shape[0], m + (-m) % shape[1])
    assert len(uca.local_shards()) == mesh.size


@pytest.mark.parametrize("shape", MESHES)
def test_accumulate_sharded_equals_jax_mesh(shape):
    W, base = _planes()
    mesh = _mesh(shape)
    got, _r = sharded.accumulate_sharded(base, W, mesh, B=8)
    want, _r = jax.jit(partial(j_sharded.accumulate_sharded,
                               mesh=_jmesh(shape), B=8, interpret=True))(
        jnp.asarray(base.numpy()), jnp.asarray(W.numpy()))
    assert isinstance(got, ShardedCanvas)
    _close(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_accumulate_sharded_pits_equals_jax_mesh(shape):
    W, base = _planes()
    links = _links(*base.shape)
    got, _r = sharded.accumulate_sharded_pits(
        base, W, _mesh(shape), *(torch.from_numpy(v) for v in links), B=8)
    jm = _jmesh(shape)
    want, _r = jax.jit(lambda b, w, s, d, lw: j_sharded.accumulate_sharded_pits(
        b, w, jm, s, d, lw, B=8, interpret=True))(
        jnp.asarray(base.numpy()), jnp.asarray(W.numpy()),
        *(jnp.asarray(v) for v in links))
    assert isinstance(got, ShardedCanvas)
    _close(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_uca_cropped_equals_jax_mesh(shape):
    """Planes of 16×30, which the blocks (and the 2x4 mesh) do not divide:
    zero-padded to whole blocks a shard, the area cropped back."""
    W, base = _planes(13, 16, 30)
    got, _r = sharded.sharded_uca(base, W, _mesh(shape), B=8)
    want, _r = jax.jit(partial(j_sharded.sharded_uca, mesh=_jmesh(shape),
                               uca_solver="blocked", B=8, interpret=True))(
        jnp.asarray(base.numpy()), jnp.asarray(W.numpy()))
    assert got.shape == (16, 30) and got.padded_shape == (16, 32)
    _close(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_uca_recut_with_links_equals_jax_mesh(shape):
    """The planes as ShardedCanvases of terrain_pre(mesh=) at 32×40: shards
    of 16×20 (2x2) or 16×10 (2x4) are not whole 16-blocks, so the blocked
    solve re-cuts them (no assembly); with pit links, against the JAX
    sharded_uca on the same planes and links."""
    n, m = 32, 40
    elev = _elev(5, n, m)
    mesh = _mesh(shape)
    _mg, _d, _f, W, base = sharded.terrain_pre(elev, *_rows(n), mesh=mesh)
    links = _links(n, m, count=24)
    got, _r = sharded.sharded_uca(base, W, mesh, pit_links=links)
    want, _r = j_sharded.sharded_uca(
        jnp.asarray(np.asarray(base)), jnp.asarray(np.asarray(W)),
        _jmesh(shape), pit_links=tuple(jnp.asarray(v) for v in links),
        uca_solver="jacobi")
    _close(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_terrain_pre_mesh_equals_jax_mesh(shape):
    n = 32
    elev = _elev(24, n, n)
    got = sharded.terrain_pre(elev, *_rows(n), mesh=_mesh(shape))
    want = jax.jit(j_sharded.terrain_pre,
                   static_argnames=("fill_flats", "mesh"))(
        jnp.asarray(elev), *(jnp.asarray(v) for v in _rows(n)),
        mesh=_jmesh(shape))
    for g, w, name in zip(got, want, ("mag", "direction", "flats", "W",
                                      "base")):
        assert isinstance(g, ShardedCanvas), name
        _close(g, w, name)


@pytest.mark.parametrize("shape", MESHES)
def test_label_flood_sharded_equals_jax_mesh(shape):
    n = 64
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = 1 - np.hypot(x, y) / np.sqrt(2.0)
    elev = np.floor((elev - elev.min() + 0.05) * 8.0) / 8.0  # ring flats
    mask = np.asarray(j_flat_mask(jnp.asarray(elev), False))
    lbl, rep = sharded.label_flood_sharded(mask, elev, _mesh(shape))
    want = jax.jit(partial(j_sharded.label_flood_sharded,
                           mesh=_jmesh(shape)))(jnp.asarray(mask),
                                                jnp.asarray(elev))
    assert lbl.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(lbl), np.asarray(want[0]))
    _close(rep, want[1])


# -- a ShardedCanvas in gives what the whole canvas gives --------------------

def _calls(mesh, use_canvas):
    """Each mesh function on fixture 13 at 32×32 (solver planes 16×32),
    its inputs whole or as ShardedCanvases: name -> its canvases (whole
    inputs give terrain_post, which takes no mesh, whole outputs)."""
    n = 32
    elev = _elev(13, n, n)
    W, base = _planes()
    links = tuple(torch.from_numpy(v) for v in _links(*base.shape))
    mask = elev > np.median(elev)

    def arg(a):
        return ShardedCanvas(split(a, mesh), mesh) if use_canvas else a

    return {
        "run_sharded": lambda: [sharded.run_sharded(
            arg(torch.from_numpy(elev)), *_rows(n), mesh=mesh,
            uca_solver="blocked")[k] for k in STEP_KEYS],
        "terrain_pre": lambda: list(sharded.terrain_pre(
            arg(torch.from_numpy(elev)), *_rows(n), mesh=mesh)),
        "label_flood_sharded": lambda: list(sharded.label_flood_sharded(
            arg(torch.from_numpy(mask)), arg(torch.from_numpy(elev)), mesh)),
        "accumulate_sharded": lambda: [sharded.accumulate_sharded(
            arg(base), arg(W), mesh, B=8)[0]],
        "accumulate_sharded_pits": lambda: [sharded.accumulate_sharded_pits(
            arg(base), arg(W), mesh, *links, B=8)[0]],
        "sharded_uca": lambda: [sharded.sharded_uca(
            arg(base), arg(W), mesh, pit_links=links)[0]],
        "terrain_post": lambda: list(sharded.terrain_post(
            *(arg(torch.from_numpy(v)) for v in (
                elev, mask, elev, np.ones_like(elev)))))}


CALLS = ["run_sharded", "terrain_pre", "label_flood_sharded",
         "accumulate_sharded", "accumulate_sharded_pits", "sharded_uca",
         "terrain_post"]


@pytest.mark.parametrize("name", CALLS)
def test_sharded_canvas_input_equals_whole(name):
    mesh = _mesh((2, 2))
    whole = _calls(mesh, False)[name]()
    given = _calls(mesh, True)[name]()
    for a, b in zip(whole, given):
        assert isinstance(b, ShardedCanvas)
        _bitwise(a, b)


@pytest.mark.parametrize("name", CALLS)
def test_mesh_functions_never_assemble(name, monkeypatch):
    """With ``assemble`` made to raise, every mesh function still runs and
    returns canvases whose host copies are filled shard by shard."""
    mesh = _mesh((2, 4))

    def refuse(*_a, **_k):
        raise AssertionError("assembled a canvas")

    monkeypatch.setattr(mesh_mod, "assemble", refuse)
    monkeypatch.setattr(ShardedCanvas, "assemble", refuse)
    out = _calls(mesh, name == "terrain_post")[name]()
    for c in out:
        assert isinstance(c, ShardedCanvas) and c.mesh is mesh
        for s, (dev, _piece) in zip(c.local_shards(), c.pieces()):
            assert s.device == dev
        assert np.asarray(c).shape == c.shape


# -- ShardedCanvas itself ----------------------------------------------------

def test_sharded_canvas_views_window_and_numpy():
    """A 10×13 canvas split from the host into 2x4 shards padded to 10×16:
    numpy() and np.asarray crop to the canvas; shard(), views() and
    window() read the right pixels; filled() sets only the padding."""
    mesh = _mesh((2, 4))
    canvas = np.arange(130, dtype=np.float64).reshape(10, 13)
    sc = ShardedCanvas(split(canvas, mesh, shape=(10, 16), pad=-1.0), mesh,
                       (10, 13))
    assert sc.padded_shape == (10, 16) and sc.shape == (10, 13)
    np.testing.assert_array_equal(np.asarray(sc), canvas)
    np.testing.assert_array_equal(np.asarray(sc, dtype=np.float32), canvas)
    assert torch.equal(sc.shard(1, 3)[:, :1],
                       torch.from_numpy(canvas[5:, 12:13]))
    assert (sc.shard(1, 3)[:, 1:] == -1).all()
    views = sc.views()
    assert [p for _v, p in views][3] == (0, 12, 5, 1)
    np.testing.assert_array_equal(sc.window((3, 8), (2, 11)).numpy(),
                                  canvas[3:8, 2:11])
    assert torch.equal(sc.assemble(), torch.from_numpy(canvas))
    filled = sc.filled(7.0)
    assert (filled[7][:, 1:] == 7).all() and filled[0] is sc.local_shards()[0]
    with pytest.raises(ValueError, match="outside"):
        sc.window((0, 11), (0, 3))
    with pytest.raises(ValueError, match="cells"):
        ShardedCanvas(split(canvas, mesh, shape=(10, 16))[:7], mesh)
    with pytest.raises(ValueError, match="canvas in shards"):
        ShardedCanvas(split(canvas, mesh, shape=(10, 16)), mesh, (12, 13))
    with pytest.raises(ValueError, match="laid over"):
        sharded.accumulate_sharded(sc, sc, _mesh((2, 2)))


def test_recut_between_layouts_round_trips():
    """retile (LocalExchange.recut) onto a larger layout and back keeps every
    pixel; beyond the source the fill shows."""
    mesh = _mesh((2, 2))
    canvas = torch.arange(2 * 12 * 10, dtype=torch.float64).view(2, 12, 10)
    src, dst = layout(mesh, (12, 10)), layout(mesh, (16, 32))
    out = mesh.exchange().recut(split(canvas, mesh), src, dst, -5.0)
    assert [tuple(t.shape) for t in out] == [(2, 8, 16)] * 4
    big = mesh_mod.assemble(out, mesh)
    assert torch.equal(big[:, :12, :10], canvas)
    assert (big[:, 12:] == -5).all() and (big[:, :, 10:] == -5).all()
    back = retile(out, dst, src, 0.0)
    assert torch.equal(mesh_mod.assemble(back, mesh), canvas)


def test_label_dtype_widens_at_two_to_the_31():
    """Labels are flat indices: int32 below 2^31 pixels, int64 from there
    (the JAX flood's choice; a 49152² canvas has 2.4e9 pixels)."""
    assert sharded._label_dtype(2 ** 31 - 1) == torch.int32
    assert sharded._label_dtype(2 ** 31) == torch.int64
    assert sharded._label_dtype(49152 ** 2) == torch.int64
