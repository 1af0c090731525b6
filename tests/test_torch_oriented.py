"""K1's ring and subset forms in the TPU's Gauss-Seidel order on the CPU,
float64, against the JAX package: the order tables, one round of every
form and orientation, the mesh's solvers.

The JAX side runs its Pallas kernel in interpret mode, as its own tests run
it; the port's side is the plain version, which the CUDA kernels equal bit
for bit on the card (``chip_smoke.py``).  B is passed explicitly and equal
on both sides.

Tolerances: flags and round counts exact; a round's canvas bitwise against
a sequential numpy loop over the blocks in the JAX grid's order (the JAX
kernel's own arithmetic, one live canvas); against the JAX kernel itself to
10 decimals (its interpret-mode sums round differently in the last bits on
the CPU, also with ``jax.disable_jit()``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu.ops import uca_block as j_ub
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch.core.stencil import NEIGHBOR_OFFSETS
from pydem_tpu_torch.ops import uca_block as t_ub
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

FORMS = ("all", "interior", "boundary")
HR, HC = j_ub.HR, j_ub.HC


def _grids(subset):
    low = 1 if subset == "all" else 3
    return [(a, b) for a in range(low, 7) for b in range(low, 8)]


def _halo(b, nb_j):
    bi, bj = divmod(b, nb_j)
    return {(bi + di) * nb_j + bj + dj
            for di in (-1, 0, 1) for dj in (-1, 0, 1)
            if (di, dj) != (0, 0) and 0 <= bj + dj < nb_j}


@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("subset", FORMS)
def test_order_tables_follow_the_jax_visit_sequence(subset, o):
    """On every grid up to 6×7 (3×3 and up for the subsets): the visit
    sequence is the JAX kernel's grid mapped through its subset branches and
    flips; every predecessor of a block is a halo neighbour of the subset
    that the sequence visits before it, and every such neighbour is one;
    no two blocks of one level are halo neighbours; the table's rows are a
    topological order; the levels are the rows' grouping."""
    for nb_i, nb_j in _grids(subset):
        seq = t_ub.visit_sequence(nb_i, nb_j, o, subset)
        fi, fj = t_ub._FLIPS[o]
        if subset == "all":
            grid = [(i, j) for i in range(nb_i) for j in range(nb_j)]
        elif subset == "interior":
            grid = [(i + 1, j + 1) for i in range(nb_i - 2)
                    for j in range(nb_j - 2)]
        else:  # the JAX kernel's frame mapping, program id t
            grid = []
            for t in range(2 * nb_j + 2 * (nb_i - 2)):
                side = t - 2 * nb_j
                grid.append((0 if t < nb_j else nb_i - 1 if t < 2 * nb_j
                             else 1 + side // 2,
                             t if t < nb_j else t - nb_j if t < 2 * nb_j
                             else (side % 2) * (nb_j - 1)))
        want = [(nb_i - 1 - i if fi else i) * nb_j
                + (nb_j - 1 - j if fj else j) for i, j in grid]
        assert seq == want, (nb_i, nb_j)
        assert len(set(seq)) == len(seq)
        pos = {b: t for t, b in enumerate(seq)}
        table = t_ub.round_table(nb_i, nb_j, o, subset)
        assert table.dtype == torch.int32
        assert table.shape == (len(seq), 1 + t_ub.MAX_PREDS)
        assert sorted(table[:, 0].tolist()) == sorted(seq)
        done = set()
        for row in table.tolist():
            b, preds = row[0], [p for p in row[1:] if p >= 0]
            assert row[1 + len(preds):] == [-1] * (t_ub.MAX_PREDS
                                                    - len(preds))
            assert set(preds) == {q for q in _halo(b, nb_j)
                                  if q in pos and pos[q] < pos[b]}
            assert set(preds) <= done  # a topological order
            done.add(b)
        levels = t_ub.round_levels(nb_i, nb_j, o, subset)
        assert torch.cat(levels).tolist() == table[:, 0].tolist()
        for level in levels:
            blocks = set(level.tolist())
            for b in blocks:
                assert not (_halo(b, nb_j) & blocks), (nb_i, nb_j, b)


def test_frame_walk_is_not_row_major():
    """The frame walk visits the bottom row before the side columns, so a
    side block next to the bottom row has it among its predecessors and
    sits above it: level t = 2p + q does not hold there."""
    table, levels = t_ub._order(4, 5, 0, "boundary")
    rows = {r[0]: [p for p in r[1:] if p >= 0] for r in table.tolist()}
    assert 3 * 5 + 0 in rows[2 * 5 + 0]  # (2, 0) waits for (3, 0)
    assert levels[2, 0] > levels[3, 0]
    with pytest.raises(ValueError, match="at least 3x3"):
        t_ub.visit_sequence(2, 5, 0, "interior")
    with pytest.raises(ValueError, match="subset must be"):
        t_ub.round_table(4, 4, 0, "frame")


def _dense(K, W1):
    return t_ub.expand_compact(torch.from_numpy(K),
                               torch.from_numpy(W1)).numpy()


def _sequential(xr, dense_r, base, prev, B, inner_max, seq):
    """One round as the TPU's grid runs it: the blocks of ``seq`` in
    order, each relaxed to its local fixed point on one live ringed canvas
    ``xr`` (numpy; 4 Jacobi sweeps a test), the frontier of ``prev``."""
    n, m = base.shape
    nb_i, nb_j = n // B, m // B
    xp = xr.copy()
    chg = np.zeros((nb_i, nb_j), np.int32)
    for b in seq:
        bi, bj = divmod(b, nb_j)
        if not prev[max(bi - 1, 0): bi + 2, max(bj - 1, 0): bj + 2].any():
            continue
        win = xp[bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
        w = dense_r[:, bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
        bb = base[bi * B: bi * B + B, bj * B: bj * B + B]
        x0 = win[1:-1, 1:-1].copy()
        it, changed = 0, True
        while it < inner_max and changed:
            for _ in range(4):
                acc = bb
                for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                    sl = (slice(1 - di, 1 - di + B),
                          slice(1 - dj, 1 - dj + B))
                    acc = acc + w[k][sl] * win[sl]
                changed = bool((acc != win[1:-1, 1:-1]).any())
                win[1:-1, 1:-1] = acc  # into the live canvas
            it += 4
        chg[bi, bj] = int((win[1:-1, 1:-1] != x0).any())
    return xp, chg


def _region(seed, n=32, m=40):
    """A shard's canvas: the receivers of fixture 5 with a ring of real
    receivers and nonzero values around the region, a base and a canvas
    on its way (every relaxed block moves by far more than an ulp)."""
    from test_torch_uca_block import _jax_state

    W, base = _jax_state(5, max(n, m))
    W, base = np.asarray(W)[:, :n, :m], np.asarray(base)[:n, :m]
    K, W1 = (np.asarray(a) for a in j_ub.compact_from_dense(jnp.asarray(W)))
    rng = np.random.RandomState(seed)
    Kr = np.pad(K, 1, constant_values=255).astype(np.uint8)
    W1r = np.pad(W1, 1)
    ring = np.ones((n + 2, m + 2), bool)
    ring[1:-1, 1:-1] = False
    # ring pixels sending into the region along one facet
    Kr[ring] = rng.randint(0, 8, ring.sum()) * 16 + 15
    W1r[ring] = 1.0
    xr = np.pad(base, 1) + rng.uniform(0, 20, (n + 2, m + 2))
    return xr, Kr, W1r, base


def _port_round(xr, Kr, W1r, base, o, B, inner_max, subset, prev=None):
    got, chg = t_ub.gs_round_oriented(
        torch.from_numpy(xr), torch.from_numpy(Kr), torch.from_numpy(W1r),
        torch.from_numpy(base), o, B=B, inner_max=inner_max, ring=True,
        subset=subset, prev=None if prev is None else torch.from_numpy(prev))
    return got.numpy(), chg.numpy()


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("subset", FORMS)
def test_ring_round_matches_sequential_loop(subset, o, sparse):
    """The plain ring round of each form == the sequential loop over the
    JAX grid's visit sequence on one live ringed canvas, bitwise, flags
    included, with every block dirty and with a sparse frontier; the ring
    comes back as it was, and ``inplace`` writes the same canvas into x."""
    B, inner_max = 8, 12
    xr, Kr, W1r, base = _region(7 + o)
    n, m = base.shape
    prev = np.ones((n // B, m // B), np.int32)
    if sparse:
        prev[:] = 0
        prev[0, 0] = prev[-1, 2] = 1
    seq = t_ub.visit_sequence(n // B, m // B, o, subset)
    want, want_chg = _sequential(xr, _dense(Kr, W1r), base, prev, B,
                                 inner_max, seq)
    got, chg = _port_round(xr, Kr, W1r, base, o, B, inner_max, subset, prev)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chg, want_chg)
    ring = np.ones(xr.shape, bool)
    ring[1:-1, 1:-1] = False
    np.testing.assert_array_equal(got[ring], xr[ring])
    x = torch.from_numpy(xr.copy())
    out, _c = t_ub.gs_round_oriented(
        x, torch.from_numpy(Kr), torch.from_numpy(W1r),
        torch.from_numpy(base), o, B=B, inner_max=inner_max, ring=True,
        subset=subset, prev=torch.from_numpy(prev), inplace=True)
    assert out is x and np.array_equal(x.numpy(), want)
    assert t_ub.launch_count(t_ub.gs_round_oriented) == 0  # the plain one


def _jax_padded(xr, Kr, W1r):
    n2, m2 = xr.shape
    xp = np.zeros((n2 - 2 + 2 * HR, m2 - 2 + 2 * HC))
    kp = np.full(xp.shape, 255, np.int32)
    wp = np.zeros(xp.shape)
    for a, v in ((xp, xr), (kp, Kr), (wp, W1r)):
        a[HR - 1: HR - 1 + n2, HC - 1: HC - 1 + m2] = v
    return jnp.asarray(xp), jnp.asarray(kp), jnp.asarray(wp)


def _jax_flags(jchg, subset, seq, nb):
    """The JAX round's flags in block coordinates: the interior grid's are
    offset by one block, the frame's are by program id along the walk."""
    jchg = np.asarray(jchg)
    out = np.zeros(nb, np.int32)
    if subset == "all":
        out[:] = jchg
    elif subset == "interior":
        out[1:-1, 1:-1] = jchg
    else:
        out.reshape(-1)[seq] = jchg[0]
    return out


@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("subset", FORMS)
def test_ring_round_matches_jax(subset, o):
    """The port's ring round of each form == the JAX ``gs_round_oriented``
    with the same ``subset`` on the same padded canvas (a shard's, with a
    nonzero ring): flags exact by block (the frame's through the walk),
    values to 10 decimals, the ring untouched."""
    B, inner_max = 8, 12
    xr, Kr, W1r, base = _region(3 + o)
    n, m = base.shape
    xp, kp, wp = _jax_padded(xr, Kr, W1r)
    jx, jchg = j_ub.gs_round_oriented(xp, kp, wp, jnp.asarray(base), o, B=B,
                                      inner_max=inner_max, interpret=True,
                                      subset=subset)
    jx = np.asarray(jx)[HR - 1: HR + n + 1, HC - 1: HC + m + 1]
    got, chg = _port_round(xr, Kr, W1r, base, o, B, inner_max, subset)
    seq = t_ub.visit_sequence(n // B, m // B, o, subset)
    np.testing.assert_array_equal(
        chg, _jax_flags(jchg, subset, seq, (n // B, m // B)))
    assert int(chg.sum()) == len(seq)  # every visited block moved
    np.testing.assert_array_almost_equal(got, jx, decimal=10)


@pytest.mark.parametrize("o", range(4))
def test_split_round_matches_jax_composed(o):
    """The split round of one shard: the interior subset in place, the ring
    landing, the frame at the same orientation against the landed ring.
    Against the JAX split round composed by hand (its interior call, the
    ring write, its frame call): flags exact, values to 10 decimals; and
    it is not the serial round, whose frame blocks run among the interior
    ones."""
    B, inner_max = 8, 12
    xr, Kr, W1r, base = _region(21 + o)
    n, m = base.shape
    landed = xr.copy()
    ring = np.ones(xr.shape, bool)
    ring[1:-1, 1:-1] = False
    landed[ring] += 5.0  # the neighbours' new edge values
    tb = torch.from_numpy(base)
    x = torch.from_numpy(xr.copy())
    K, W1 = torch.from_numpy(Kr), torch.from_numpy(W1r)
    kw = dict(B=B, inner_max=inner_max, ring=True, inplace=True)
    _x, chg_i = t_ub.gs_round_oriented(x, K, W1, tb, o, subset="interior",
                                       **kw)
    x[torch.from_numpy(ring)] = torch.from_numpy(landed[ring])
    _x, chg_b = t_ub.gs_round_oriented(x, K, W1, tb, o, subset="boundary",
                                       **kw)
    xp, kp, wp = _jax_padded(xr, Kr, W1r)
    jargs = dict(B=B, inner_max=inner_max, interpret=True)
    xp, ji = j_ub.gs_round_oriented(xp, kp, wp, jnp.asarray(base), o,
                                    subset="interior", **jargs)
    xp = xp.at[HR - 1: HR + n + 1, HC - 1: HC + m + 1].set(
        jnp.where(jnp.asarray(ring), jnp.asarray(landed),
                  xp[HR - 1: HR + n + 1, HC - 1: HC + m + 1]))
    xp, jb = j_ub.gs_round_oriented(xp, kp, wp, jnp.asarray(base), o,
                                    subset="boundary", **jargs)
    nb = (n // B, m // B)
    seq_b = t_ub.visit_sequence(*nb, o, "boundary")
    np.testing.assert_array_equal(chg_i.numpy(),
                                  _jax_flags(ji, "interior", None, nb))
    np.testing.assert_array_equal(chg_b.numpy(),
                                  _jax_flags(jb, "boundary", seq_b, nb))
    jx = np.asarray(xp)[HR - 1: HR + n + 1, HC - 1: HC + m + 1]
    np.testing.assert_array_almost_equal(x.numpy(), jx, decimal=10)
    serial, _c = t_ub.gs_round_oriented(torch.from_numpy(landed), K, W1, tb,
                                        o, B=B, inner_max=inner_max,
                                        ring=True)
    assert not torch.equal(serial, x)


def _planes(case=13, n=48, m=96):
    from test_torch_sharded import _planes as planes

    return planes(case, n, m)


def _fixture_links(case=13, n=32):
    """A fixture's host pit links (its pits left in), as the JAX package's
    tests build them, with its planes."""
    from test_torch_uca_block import _pit_inputs

    W, base, *links = _pit_inputs(case, n)
    return W, base, links


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
@pytest.mark.parametrize("pits", [False, True])
def test_sharded_solvers_match_jax_mesh(shape, pits):
    """accumulate_sharded and accumulate_sharded_pits (the serial round)
    against the JAX functions on the same mesh of the virtual CPU devices
    at the same B: the JAX solvers' rounds, values to 10 decimals."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    B = 8
    jm = j_sharded.make_mesh(jax.devices()[: shape[0] * shape[1]],
                             shape=shape)
    mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
    if pits:
        W, base, links = _fixture_links()
        assert len(links[0])
        want, jr = j_sharded.accumulate_sharded_pits(
            base, W, jm, *(jnp.asarray(a) for a in links), B=B,
            interpret=True)
        got, rounds = sharded.accumulate_sharded_pits(
            torch.tensor(np.asarray(base)), torch.tensor(np.asarray(W)),
            mesh, *(torch.from_numpy(np.asarray(a)) for a in links), B=B)
    else:
        W, base = _planes()
        want, jr = j_sharded.accumulate_sharded(
            jnp.asarray(base.numpy()), jnp.asarray(W.numpy()), jm, B=B,
            interpret=True)
        got, rounds = sharded.accumulate_sharded(base, W, mesh, B=B)
    assert sharded._blocked_shards.last_split is False
    assert rounds == int(jr) and rounds > 1
    np.testing.assert_array_almost_equal(got.assemble().numpy(),
                                         np.asarray(want), decimal=10)


@pytest.mark.parametrize("pits", [False, True])
def test_one_by_one_mesh_is_the_in_core_solve(pits):
    """A 1×1 mesh (one shard, its ring all zeros, no frontier) equals one
    device's ``accumulate_blocked_gs`` / ``accumulate_blocked_pits_gs`` at
    the same B bit for bit, rounds equal on these inputs (the in-core
    solver's frontier could cost or save a round elsewhere); on the 128²
    cone at B = 16 both take the JAX solver's 5 rounds."""
    from test_torch_uca_block import _cone_state

    one = make_mesh([torch.device("cpu")], (1, 1))
    if pits:
        W, base, links = _fixture_links()
        W, base = torch.tensor(np.asarray(W)), torch.tensor(np.asarray(base))
        links = [torch.from_numpy(np.asarray(a)) for a in links]
        want, wr = t_ub.accumulate_blocked_pits_gs(base, W, *links, B=8)
        got, rounds = sharded.accumulate_sharded_pits(base, W, one, *links,
                                                      B=8)
    else:
        W, base = (torch.tensor(np.asarray(a)) for a in _cone_state())
        want, wr = t_ub.accumulate_blocked_gs(base, W, B=16)
        got, rounds = sharded.accumulate_sharded(base, W, one, B=16)
        assert rounds == 5
    assert rounds == wr and torch.equal(got.assemble(), want)


def test_oriented_forms_reject_bad_arguments():
    """A flag ring, a subset grid under 3×3, an unknown subset, and an x
    without its ring."""
    x = torch.zeros((18, 18), dtype=torch.float64)
    K = torch.full((18, 18), 255, dtype=torch.uint8)
    base = torch.zeros((16, 16), dtype=torch.float64)
    kw = dict(B=8, inner_max=8, ring=True)
    with pytest.raises(ValueError, match="prev has shape"):
        t_ub.gs_round_oriented(x, K, x, base, 0,
                               prev=torch.ones((4, 4), dtype=torch.int32),
                               **kw)
    with pytest.raises(ValueError, match="at least 3x3"):
        t_ub.gs_round_oriented(x, K, x, base, 0, subset="interior", **kw)
    with pytest.raises(ValueError, match="subset must be"):
        t_ub.gs_round_oriented(x, K, x, base, 0, subset="rim", **kw)
    with pytest.raises(ValueError, match="expected"):
        t_ub.gs_round_oriented(x[1:-1, 1:-1].contiguous(), K, x, base, 0,
                               **kw)
