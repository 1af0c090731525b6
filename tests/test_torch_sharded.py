"""pydem_tpu_torch.parallel (the mesh, the sharded flood, pre-stencils and
solvers) on the CPU, float64: sharded == the port's single-device functions
bit for bit, and the slice against the JAX package.

Meshes here are lists of CPU devices (``make_mesh([cpu] * 4, (2, 2))``), the
in-process back end; the plain rounds stand in for the kernels.  The solver
tests use B = 8, which the plain rounds take, to keep the shards small.

The sharded K1 rounds run the TPU's Gauss-Seidel order in place, as the
JAX solver's do: each shard its own sequential grid against a ring frozen
at the round's start, every block every round.  So the rounds depend on
the mesh's shape.  What holds: any mesh reaches the fixed point of one
device's in-core solve (``accumulate_blocked_gs``) bit for bit (every
pixel's sum is one rounding sequence), and the rounds are the JAX solver's
on the same mesh (``tests/test_torch_oriented.py``).  On these fixtures a
1×1 mesh also takes the in-core solve's rounds; in general it need not,
since the in-core solver threads a frontier and the mesh does not.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import fixtures as j_fixtures
from pydem_tpu.core.flats_device import _flat_mask as j_flat_mask
from pydem_tpu.core.slope_direction import label_flood as j_label_flood
from pydem_tpu.ops import uca_block as j_ub
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch import fixtures
from pydem_tpu_torch.core.slope_direction import label_flood
from pydem_tpu_torch.ops import uca_block as ub
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.parallel.mesh import (Mesh, assemble, check_mesh,
                                           make_mesh, shard_dims, split)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2), (2, 4)]


def _mesh(shape):
    return make_mesh([CPU] * (shape[0] * shape[1]), shape)


ONE = (1, 1)  # the one-shard mesh: one device's in-core solve, bitwise


def _same_fixed_point(got, want):
    """``got`` and ``want`` (converged solves of any shape or order) are the
    same fixed point, bit for bit."""
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _ones(n):
    return (torch.ones(n - 1, dtype=torch.float64),) * 2 + (
        torch.ones(n, dtype=torch.float64),) * 2


def _planes(case=13, n=48, m=96):
    """Receiver planes and base of a fixture cut to n × m."""
    elev, _a, _u = fixtures.get_test_case(case, max(n, m))
    elev = torch.from_numpy(np.ascontiguousarray(elev[:n, :m], "float64"))
    _mag, _d, _f, W, base = sharded.terrain_pre(elev, *_ones(n))
    return W, base.contiguous()


def _links(n, m, count=120, seed=4):
    """Random pit links, several into each destination, each dropping rows
    down the fixture (acyclic with its flow)."""
    rng = np.random.RandomState(seed)
    dst_i = rng.randint(8, n, count // 4).repeat(4)
    dst = dst_i * m + rng.randint(0, m, count // 4).repeat(4)
    src = (dst_i - rng.randint(2, 8, count)) * m + rng.randint(0, m, count)
    w = rng.uniform(0, 0.5, count)
    return tuple(torch.from_numpy(a) for a in (src, dst, w))


def test_make_mesh_factorizes_and_checks():
    assert _mesh((2, 4)).devices.shape == (2, 4)
    assert make_mesh([CPU] * 6).devices.shape == (2, 3)
    assert make_mesh([CPU] * 7).devices.shape == (1, 7)
    mesh = make_mesh([CPU] * 4)
    assert mesh.size == 4 and mesh.distinct_devices == 1
    assert mesh.device_type == "cpu" and not mesh.distributed
    cards = Mesh(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], (2, 2))
    assert cards.distinct_devices == 2 and not sharded._one_card(cards)
    assert sharded.make_mesh is make_mesh  # re-exported, as in the JAX one
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh([CPU] * 3, (2, 2))
    with pytest.raises(TypeError, match="Mesh"):
        check_mesh(object(), CPU)
    with pytest.raises(ValueError, match="devices are cpu"):
        check_mesh(mesh, "cuda")
    with pytest.raises(ValueError, match="does not divide"):
        split(torch.zeros(5, 8), mesh)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", MESHES + [(3, 3)])
def test_halo_exchange_reads_the_canvas_around_each_shard(shape, depth):
    """Each shard's ring after the exchange is the canvas around it (rows,
    then columns: the corners come through the y-neighbour); where the
    canvas ends the ring keeps its fill."""
    mesh = _mesh(shape)
    n, m = 6 * shape[0], 4 * shape[1]
    canvas = torch.arange(n * m, dtype=torch.float64).view(n, m) + 1
    planes = mesh.exchange().halo(split(canvas, mesh, ring=depth, fill=-1.0),
                                  depth)
    padded = torch.nn.functional.pad(canvas, (depth,) * 4, value=-1.0)
    n_l, m_l = n // shape[0], m // shape[1]
    for (iy, ix), p in zip(mesh.local_shards(), planes):
        want = padded[iy * n_l: (iy + 1) * n_l + 2 * depth,
                      ix * m_l: (ix + 1) * m_l + 2 * depth]
        assert torch.equal(p, want), (iy, ix)
    assert torch.equal(assemble(planes, mesh, ring=depth), canvas)


def _sharded_solve(base, W, mesh, split_round, links=None):
    """The public solver where it takes the serial round (on the CPU it
    always does); the split round through the solver's private switch."""
    if not split_round:
        area, rounds = (
            sharded.accumulate_sharded(base, W, mesh, B=8) if links is None
            else sharded.accumulate_sharded_pits(base, W, mesh, *links, B=8))
        got = (area.assemble(), rounds)
    else:
        n_l, m_l = shard_dims(base.shape, mesh)
        area_s, rounds = sharded._blocked_shards(
            split(base, mesh), split(W, mesh), mesh, 8,
            links=sharded._links_of(links, mesh, n_l, m_l, base.dtype),
            _force_split=True)
        got = (assemble(area_s, mesh), rounds)
    assert sharded._blocked_shards.last_split is split_round
    return got


@pytest.mark.parametrize("split_round", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_solver_equals_one_device(shape, split_round):
    """accumulate_sharded, serial and split (shards of 3×3 blocks and
    more), reaches one device's fixed point bit for bit; on a 1×1 mesh it
    is accumulate_blocked_gs bit for bit, rounds equal."""
    W, base = _planes()
    gs, gs_rounds = ub.accumulate_blocked_gs(base, W, B=8)
    want, rw = _sharded_solve(base, W, _mesh(ONE), False)
    assert rw == gs_rounds and torch.equal(want, gs)
    got, rg = _sharded_solve(base, W, _mesh(shape), split_round)
    _same_fixed_point(got, want)
    assert rg >= 1


@pytest.mark.parametrize("split_round", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_pit_solver_equals_one_device(shape, split_round):
    """accumulate_sharded_pits (the fold adds each destination's links in
    link order, as PitLinks does) reaches one device's fixed point bit for
    bit; on a 1×1 mesh it is accumulate_blocked_pits_gs bit for bit, rounds
    equal."""
    W, base = _planes()
    links = _links(*base.shape)
    gs, gs_rounds = ub.accumulate_blocked_pits_gs(base, W, *links, B=8)
    want, rw = _sharded_solve(base, W, _mesh(ONE), False, links)
    assert rw == gs_rounds and torch.equal(want, gs)
    assert rw > 4  # the links move the fixed point round after round
    got, rg = _sharded_solve(base, W, _mesh(shape), split_round, links)
    _same_fixed_point(got, want)
    assert rg >= 1


def test_sharded_pit_solver_matches_the_jax_package():
    """The sharded pit solver against the JAX package's single-device K1
    pit solver (Pallas in interpret mode), decimal=10."""
    n, m = 16, 32
    W, base = _planes(13, n, m)
    links = _links(n, m, count=12)
    got, _r = sharded.accumulate_sharded_pits(base, W, _mesh((2, 2)), *links,
                                              B=8)
    want, _r = j_ub.accumulate_blocked_pits_gs(
        jnp.asarray(base.numpy()), jnp.asarray(W.numpy()),
        *(jnp.asarray(v.numpy()) for v in links), B=8, interpret=True)
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
def test_sharded_uca_pads_and_equals_one_device(solver):
    """sharded_uca on a canvas the mesh and the blocks do not divide, with
    links: the zero pad is exact (jacobi bitwise equal to
    core.uca.accumulate; blocked the fixed point of one device's K1 on the
    padded canvas, bit for bit, which the same call on a 1×1 mesh equals
    with equal rounds)."""
    from pydem_tpu_torch.core.uca import accumulate

    W, base = _planes(13, 45, 70)
    links = _links(45, 70, count=40)
    got, rg = sharded.sharded_uca(base, W, _mesh((2, 4)), pit_links=links,
                                  uca_solver=solver, B=16)
    got = got.assemble()
    if solver == "jacobi":
        want, rw = accumulate(base, W, *links)
    else:
        p = torch.nn.functional.pad
        pb, pW = p(base, (0, 10, 0, 3)), p(W, (0, 10, 0, 3))
        remap = [(v // 70) * 80 + v % 70 for v in links[:2]]
        gs, gs_rounds = ub.accumulate_blocked_pits_gs(pb, pW, *remap,
                                                      links[2], B=16)
        _same_fixed_point(got, gs[:45, :70])
        want, rw = sharded.sharded_uca(base, W, _mesh(ONE), pit_links=links,
                                       uca_solver=solver, B=16)
        want = want.assemble()
        assert rw == gs_rounds and torch.equal(want, gs[:45, :70])
        rw = rg  # the mesh's rounds are its shape's
    assert rg == rw and torch.equal(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_label_flood_sharded_matches_label_flood(shape):
    """The sharded flood == the port's label_flood (labels and reps) on a
    flats-heavy quantized cone whose regions span many shards; and both
    == the JAX label_flood."""
    n = 64
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = 1 - np.hypot(x, y) / np.sqrt(2.0)
    elev = np.floor((elev - elev.min() + 0.05) * 8.0) / 8.0  # ring flats
    mask_j = j_flat_mask(jnp.asarray(elev), False)
    mask = torch.from_numpy(np.asarray(mask_j))
    e = torch.from_numpy(elev)
    lbl, rep = label_flood(mask, e)
    lbl_s, rep_s = sharded.label_flood_sharded(mask, e, _mesh(shape))
    lbl_s, rep_s = lbl_s.assemble(), rep_s.assemble()
    assert lbl_s.dtype == lbl.dtype == torch.int32
    assert torch.equal(lbl_s, lbl)
    assert torch.equal(torch.nan_to_num(rep_s), torch.nan_to_num(rep))
    lbl_j, _rep_j = j_label_flood(mask_j, jnp.asarray(elev))
    np.testing.assert_array_equal(lbl_s.numpy(), np.asarray(lbl_j))


@pytest.mark.parametrize("case", [16, 13, 24])
def test_terrain_pre_mesh_equals_unsharded(case):
    """terrain_pre(mesh=3×3) == terrain_pre on one device, bitwise, on a
    mesh with corner, edge and interior shards; the flats-bearing and
    masked fixtures exercise the sharded flood and the NaN edges."""
    n = 48
    elev, _a, _u = fixtures.get_test_case(case, n)
    elev = torch.from_numpy(np.asarray(elev, "float64"))
    want = sharded.terrain_pre(elev, *_ones(n))
    got = sharded.terrain_pre(elev, *_ones(n), mesh=_mesh((3, 3)))
    got = [c.assemble() for c in got]
    for a, b, name in zip(want, got, ("mag", "dir", "flats", "W", "base")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), name


def test_pre_halo_one_short_differs():
    """The pre-stencils need an elevation halo of PRE_HALO = 1 px: with none
    the shards' rims are taken for the canvas edge and slope, direction and
    the weights differ there (and only near the shards' edges)."""
    n = 48
    elev, _a, _u = fixtures.get_test_case(33, n)
    elev = torch.from_numpy(np.asarray(elev, "float64"))
    mesh = _mesh((3, 3))
    rows = _ones(n)
    good = sharded._pre_shards(split(elev, mesh), *rows, mesh)
    short = sharded._pre_shards(split(elev, mesh), *rows, mesh,
                                halo=sharded.PRE_HALO - 1)
    assert sharded.PRE_HALO == 1
    mag = assemble(good["mag"], mesh)
    mag0 = assemble(short["mag"], mesh)
    diff = mag != mag0
    assert diff.any()
    edge = torch.zeros_like(diff)
    for k in (16, 32):  # the shards' edges
        edge[k - 1: k + 1, :] = True
        edge[:, k - 1: k + 1] = True
    assert not (diff & ~edge).any()
    assert not torch.equal(assemble(good["W"], mesh),
                           assemble(short["W"], mesh))


def _jax_step(elev, n, m):
    args = [jnp.asarray(elev), jnp.ones(n - 1), jnp.ones(n - 1),
            jnp.ones(n), jnp.ones(n)]
    with jax.disable_jit():
        return j_sharded.terrain_step(*args, uca_solver="jacobi")


def _assert_step(got, want, keys=("mag", "direction", "uca", "twi")):
    for key in keys:
        g, w = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        np.testing.assert_array_almost_equal(
            np.nan_to_num(g), np.nan_to_num(w), decimal=10, err_msg=key)
    np.testing.assert_array_equal(got["flats"].numpy(),
                                  np.asarray(want["flats"]))


@pytest.mark.parametrize("solver", ["jacobi", "blocked"])
@pytest.mark.parametrize("case", [33, 5, 13])
def test_run_sharded_matches_jax_terrain_step(case, solver):
    """run_sharded over a 2×4 mesh on fixtures 33, 5, 13 against the JAX
    package's single-device terrain_step (op by op: jitted, XLA contracts
    an FMA in the facet sweep), decimal=10; and against the port's own
    run_sharded on a 1×1 mesh and its terrain_step, bitwise (jacobi: equal
    sweeps; blocked: the same fixed point, and the 1×1 mesh in the in-core
    solve's rounds)."""
    n = 32
    elev, _a, _u = j_fixtures.get_test_case(case, n)
    want = _jax_step(elev, n, n)
    t_elev = torch.from_numpy(np.asarray(elev, "float64"))
    got = sharded.run_sharded(t_elev, *_ones(n), mesh=_mesh((2, 4)),
                              uca_solver=solver)
    _assert_step(got, want)
    ones = [sharded.run_sharded(t_elev, *_ones(n), mesh=_mesh(ONE),
                                uca_solver=solver)]
    ones = [{k: v.assemble() if k != "uca_sweeps" else v
             for k, v in ones[0].items()}]
    step = sharded.terrain_step(t_elev, *_ones(n), uca_solver=solver)
    ones.append(step)
    assert ones[0]["uca_sweeps"] == step["uca_sweeps"]
    for one in ones:
        for key in ("mag", "direction", "flats", "uca", "twi"):
            assert torch.equal(
                torch.nan_to_num(got[key].assemble().double()),
                torch.nan_to_num(one[key].double())), key
        if solver == "jacobi":
            assert got["uca_sweeps"] == one["uca_sweeps"]


def test_run_sharded_uneven_shape_pads_with_nan():
    """A 32×30 canvas over 2×4: the columns are padded with NaN to 32 (the
    padded canvas is the computed domain, as in the JAX package), and the
    result equals the JAX single-device step on the padded canvas."""
    elev, _a, _u = j_fixtures.get_test_case(33, 32)
    elev = np.asarray(elev, "float64")[:, :30]
    elev_pad = np.pad(elev, ((0, 0), (0, 2)), constant_values=np.nan)
    want = _jax_step(elev_pad, 32, 32)
    got = sharded.run_sharded(elev, np.ones(31), np.ones(31), np.ones(32),
                              np.ones(32), mesh=_mesh((2, 4)),
                              uca_solver="blocked")
    assert got["uca"].shape == (32, 30)
    sliced = {k: (np.asarray(v)[:, :30] if np.ndim(v) == 2 else v)
              for k, v in want.items()}
    _assert_step(got, sliced)


def test_run_sharded_fixed_sweeps_equal_one_device():
    n = 32
    elev, _a, _u = fixtures.get_test_case(13, n)
    t = torch.from_numpy(np.asarray(elev, "float64"))
    got = sharded.run_sharded(t, *_ones(n), mesh=_mesh((2, 2)), n_sweeps=6)
    one = sharded.terrain_step(t, *_ones(n), n_sweeps=6)
    assert got["uca_sweeps"] == 6
    assert torch.equal(torch.nan_to_num(got["uca"].assemble()),
                       torch.nan_to_num(one["uca"]))


def test_sharded_pipeline_stages_and_halo_metrics():
    """ShardedPipeline.pre == the unsharded stencils; uca with the host's
    pit links reaches the fixed point of one device's solve bit for bit
    (which a 1×1 mesh equals with equal rounds); halo_metrics reports the
    ring geometry and, measured, the three host-clock round times."""
    n = 32
    elev, _a, _u = fixtures.get_test_case(13, n)
    elev = np.asarray(elev, "float64")
    ones = np.ones(n)
    sp = sharded.ShardedPipeline(elev, ones[1:], ones[1:], ones, ones,
                                 _mesh((2, 2)), uca_solver="blocked")
    mag, direction, flats = sp.pre()
    want = sharded.terrain_pre(torch.from_numpy(elev), *_ones(n))
    np.testing.assert_array_equal(mag, want[0].numpy())
    np.testing.assert_array_equal(direction, want[1].numpy())
    np.testing.assert_array_equal(flats, want[2].numpy())
    links = _links(n, n, count=20)
    area, rounds = sp.uca(tuple(v.numpy() for v in links))
    ref, rr = sharded.accumulate_sharded_pits(want[4], want[3],
                                              _mesh(ONE), *links, B=16)
    gs, gs_rounds = ub.accumulate_blocked_pits_gs(want[4].contiguous(),
                                                  want[3], *links, B=16)
    assert rr == gs_rounds and torch.equal(ref.assemble(), gs)
    _same_fixed_point(torch.from_numpy(area), gs)
    hm = sp.halo_metrics(measure=True)
    assert hm["mesh_shape"] == [2, 2] and hm["uca_rounds"] == rounds
    assert hm["halo_px_per_round_per_shard"] == 2 * 18 + 2 * 16
    assert hm["timer"] == "host clock" and not hm["one_card"]
    for mode in ("exchange", "relax", "full"):
        assert hm["t_%s_per_round" % mode] > 0
    frac = hm["overlap_fraction"]
    assert frac is None or 0.0 <= frac <= 1.0


def test_split_round_arguments():
    W, base = _planes(13, 32, 32)
    mesh = _mesh((2, 2))
    with pytest.raises(ValueError, match="at least 3x3"):
        sharded._blocked_shards(split(base, mesh), split(W, mesh), mesh, 8,
                                _force_split=True)
    with pytest.raises(ValueError, match="one process"):
        sharded._use_split(Mesh(["cuda:0", "cuda:1"], (1, 2),
                                distributed=True), (4, 4), True)
    assert not sharded._use_split(Mesh(["cuda:0", "cuda:1"], (1, 2),
                                       distributed=True), (4, 4))
    # several cards of this process: the rule picks the serial round (the
    # split one measured slower there) and refuses nothing; forced, it splits
    cards = Mesh(["cuda:%d" % k for k in range(4)], (2, 2))
    assert sharded._use_split(cards, (4, 4), True)
    assert not sharded._use_split(cards, (4, 4), False)
    assert not sharded._use_split(cards, (4, 4))
    assert not sharded._use_split(cards, (2, 4))
    assert sharded._use_split(Mesh(["cuda:0"] * 2, (1, 2)), (3, 3))
    assert not sharded._use_split(Mesh(["cuda:0"] * 2, (1, 2)), (2, 4))
    with pytest.raises(ValueError, match="too small"):
        sharded.accumulate_sharded(base[:, :30], W[..., :30], _mesh((1, 2)))
    with pytest.raises(ValueError, match="uca_solver"):
        sharded.sharded_uca(base, W, _mesh((1, 2)), uca_solver="gs")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sharded._use_split(_mesh((2, 2)), (4, 4)) is False


@pytest.mark.parametrize("cells, want", [
    (["cuda:0"] * 4, [("cuda:0", [0, 1, 2, 3])]),
    (["cuda:%d" % k for k in range(4)],
     [("cuda:%d" % k, [k]) for k in range(4)]),
    (["cuda:0", "cuda:1"] * 4, [("cuda:0", [0, 2, 4, 6]),
                                ("cuda:1", [1, 3, 5, 7])]),
    (["cpu"] * 2, [("cpu", [0, 1])])])
def test_devices_of(cells, want):
    """The distinct devices of a mesh, each with the shards it holds (in
    local_shards order): what the split round and the engine's per-card
    budget group by.  Descriptor-only CUDA devices need no card."""
    shape = (2, len(cells) // 2) if len(cells) > 2 else (1, 2)
    got = Mesh(cells, shape).devices_of()
    assert [(str(d), ks) for d, ks in got] == want
