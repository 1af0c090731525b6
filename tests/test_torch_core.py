"""pydem_tpu_torch.core == pydem_tpu.core, module by module (CPU, float64).

Each stage gets the JAX package's own output of the stage before it, so a
difference is charged to the stage that made it.  Integer and bool planes
must match exactly (``reachability`` and ``grid_edge_mask`` too).  Float
planes that pass through ``atan2`` (mag, direction, proportion, W) are held
to rtol 1e-12: XLA's and PyTorch's ``atan2`` may differ in the last ulp.  UCA and TWI use ``decimal=10``, as
``tests/test_uca_block.py`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import fixtures
from pydem_tpu.core import receivers as j_rec
from pydem_tpu.core import slope_direction as j_sd
from pydem_tpu.core import stencil as j_st
from pydem_tpu.core import twi as j_twi
from pydem_tpu.core import uca as j_uca
from pydem_tpu_torch.core import receivers as t_rec
from pydem_tpu_torch.core import slope_direction as t_sd
from pydem_tpu_torch.core import stencil as t_st
from pydem_tpu_torch.core import twi as t_twi
from pydem_tpu_torch.core import uca as t_uca

torch.set_num_threads(1)

CASES = [33, 5, 24, 13, 16, 30]
N = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=0)


def _spacing(graded):
    """Unit spacing, or row-graded spacing that exercises the per-row facet
    distances and section angles."""
    if graded:
        dX = np.linspace(0.8, 1.2, N - 1)
        dY = np.linspace(1.1, 0.9, N - 1)
    else:
        dX = dY = np.ones(N - 1)
    return dX, dY


@pytest.fixture(scope="module")
def chain():
    """JAX stage outputs per (case, graded)."""
    cache = {}

    def get(case, graded):
        key = (case, graded)
        if key not in cache:
            elev, _a, _u = fixtures.get_test_case(case, N)
            dX, dY = _spacing(graded)
            je = jnp.asarray(elev)
            mag, direction = j_sd.slopes_directions(je, jnp.asarray(dX),
                                                    jnp.asarray(dY))
            flats = j_sd.find_flats_edges(je, mag, direction)
            direction = jnp.where(flats, -1, direction)
            mag = jnp.where(flats, -1, mag)
            section, proportion = j_rec.section_proportion(
                direction, flats, jnp.asarray(dX), jnp.asarray(dY))
            W = j_rec.receiver_weights(section, proportion, je)
            base = j_uca.base_area(jnp.ones(N), jnp.ones(N), je.shape,
                                   je.dtype)
            cache[key] = dict(elev=elev, dX=dX, dY=dY, mag=mag,
                              direction=direction, flats=flats,
                              section=section, proportion=proportion, W=W,
                              base=base)
        return cache[key]
    return get


@pytest.mark.parametrize("fill,dtype", [(np.nan, np.float64), (7, np.int32),
                                        (False, np.bool_)])
def test_shift_matches(fill, dtype):
    elev, _a, _u = fixtures.get_test_case(24, N)
    arr = (elev * 100).astype(dtype) if dtype != np.bool_ else elev > 0.5
    for di, dj in t_st.NEIGHBOR_OFFSETS:
        want = np.asarray(j_st.shift(jnp.asarray(arr), di, dj, fill))
        got = t_st.shift(_t(arr), di, dj, fill).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(j_st.scatter_shift(jnp.asarray(arr), di, dj, fill))
        got = t_st.scatter_shift(_t(arr), di, dj, fill).numpy()
        np.testing.assert_array_equal(got, want)


def test_tables_match():
    assert t_st.NEIGHBOR_OFFSETS == j_st.NEIGHBOR_OFFSETS
    assert t_st.OFFSET_INDEX == j_st.OFFSET_INDEX
    assert t_st.FACET_E1 == j_st.FACET_E1
    assert t_st.FACET_E2 == j_st.FACET_E2
    np.testing.assert_array_equal(t_st.ANG_ADJ, j_st.ANG_ADJ)


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_slopes_directions_match(chain, case, graded):
    c = chain(case, graded)
    mag, direction = j_sd.slopes_directions(
        jnp.asarray(c["elev"]), jnp.asarray(c["dX"]), jnp.asarray(c["dY"]))
    tm, td = t_sd.slopes_directions(_t(c["elev"]), _t(c["dX"]), _t(c["dY"]))
    _close(tm, mag)
    _close(td, direction)


@pytest.mark.parametrize("case", CASES)
def test_label_flood_matches(chain, case):
    c = chain(case, False)
    mask = np.asarray(c["mag"]) == -1
    lbl, rep = j_sd.label_flood(jnp.asarray(mask), jnp.asarray(c["elev"]))
    tl, tr = t_sd.label_flood(_t(mask), _t(c["elev"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(lbl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rep))


def test_label_flood_refuses_int32_overflow():
    mask = torch.zeros((1, 1), dtype=torch.bool).expand(2 ** 16, 2 ** 15)
    with pytest.raises(ValueError, match="overflow"):
        t_sd.label_flood(mask, mask)


@pytest.mark.parametrize("case", CASES)
def test_find_flats_edges_matches(chain, case):
    c = chain(case, False)
    mag, _d = j_sd.slopes_directions(jnp.asarray(c["elev"]),
                                     jnp.asarray(c["dX"]),
                                     jnp.asarray(c["dY"]))
    got = t_sd.find_flats_edges(_t(c["elev"]), _t(mag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(c["flats"]))


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_section_proportion_matches(chain, case, graded):
    c = chain(case, graded)
    sec, prop = t_rec.section_proportion(_t(c["direction"]), _t(c["flats"]),
                                         _t(c["dX"]), _t(c["dY"]))
    np.testing.assert_array_equal(sec.numpy(), np.asarray(c["section"]))
    _close(prop, c["proportion"])
    theta = t_rec.section_theta(_t(c["dX"]), _t(c["dY"]), N)
    _close(theta, j_rec.section_theta(jnp.asarray(c["dX"]),
                                      jnp.asarray(c["dY"]), N))


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_section_proportion_theta_matches(chain, case, graded):
    """``theta=``: a window of rows with the *global* row angles gives the
    global planes' rows (section exact, proportion ``decimal=12``), in the
    port as in the JAX function."""
    c = chain(case, graded)
    theta = np.asarray(j_rec.section_theta(
        jnp.asarray(c["dX"]), jnp.asarray(c["dY"]), N))[:, 0]
    rows = slice(3, N - 5)
    direction = np.asarray(c["direction"])[rows]
    flats = np.asarray(c["flats"])[rows]
    sec, prop = t_rec.section_proportion(_t(direction), _t(flats),
                                         theta=_t(theta[rows]))
    jsec, jprop = j_rec.section_proportion(
        jnp.asarray(direction), jnp.asarray(flats), theta=theta[rows])
    np.testing.assert_array_equal(sec.numpy(), np.asarray(jsec))
    np.testing.assert_array_almost_equal(prop.numpy(), np.asarray(jprop),
                                         decimal=12)
    np.testing.assert_array_equal(sec.numpy(),
                                  np.asarray(c["section"])[rows])
    _close(prop, np.asarray(c["proportion"])[rows])
    # theta as numpy, a list-like column or a tensor: the same planes
    sec2, prop2 = t_rec.section_proportion(_t(direction), _t(flats),
                                           theta=theta[rows][:, None])
    assert torch.equal(sec, sec2)
    assert torch.equal(torch.nan_to_num(prop), torch.nan_to_num(prop2))


def test_section_proportion_negative_sections():
    """A non-flat pixel with direction -1 gives section -2, and flats -1:
    both index the angle table from its end, as numpy indexing does."""
    direction = np.array([[-1.0, -1.0, 0.3, 2.0, 5.9, 6.2]] * 4)
    flats = np.zeros(direction.shape, bool)
    flats[:, 1] = True
    dX = dY = np.ones(3)
    sec, prop = j_rec.section_proportion(jnp.asarray(direction),
                                         jnp.asarray(flats), jnp.asarray(dX),
                                         jnp.asarray(dY))
    tsec, tprop = t_rec.section_proportion(_t(direction), _t(flats), _t(dX),
                                           _t(dY))
    assert set(np.asarray(sec)[:, :2].ravel()) == {-2, -1}
    np.testing.assert_array_equal(tsec.numpy(), np.asarray(sec))
    _close(tprop, prop)


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_receiver_weights_match(chain, case, graded):
    c = chain(case, graded)
    got = t_rec.receiver_weights(_t(c["section"]), _t(c["proportion"]),
                                 _t(c["elev"]))
    _close(got, c["W"])


def test_base_area_matches():
    dX2 = np.linspace(0.5, 1.5, N)
    dY2 = np.linspace(2.0, 1.0, N)
    want = j_uca.base_area(jnp.asarray(dX2), jnp.asarray(dY2), (N, N + 3))
    got = t_uca.base_area(_t(dX2), _t(dY2), (N, N + 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES)
def test_accumulate_twi_match(chain, case):
    """Jacobi UCA, finalize and TWI on the JAX package's weights."""
    c = chain(case, False)
    W, base = _t(c["W"]), _t(c["base"])
    sweep = t_uca.flow_sweep(base, W)
    np.testing.assert_array_almost_equal(
        sweep.numpy(), np.asarray(j_uca.flow_sweep(c["base"], c["W"])),
        decimal=12)

    area, sweeps = j_uca.accumulate(c["base"], c["W"])
    ta, tsweeps = t_uca.accumulate(base, W)
    assert tsweeps == int(sweeps)
    np.testing.assert_array_almost_equal(ta.numpy(), np.asarray(area),
                                         decimal=10)

    uca = j_uca.finalize_uca(area, c["flats"])
    tu = t_uca.finalize_uca(_t(area), _t(c["flats"]))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(uca))
    min_area = float(jnp.nanmin(c["base"]))
    for kw in ({}, dict(cap_uca=True, cap_twi=True)):
        want = j_twi.twi(uca, c["mag"], min_area, **kw)
        got = t_twi.twi(tu, _t(c["mag"]), min_area, **kw)
        np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                             decimal=10)


def test_sqrt_rn_is_correctly_rounded():
    """sqrt_rn == numpy's (IEEE) square root bitwise, where PyTorch's CPU
    float64 sqrt is an ulp off for some inputs (sqrt(2.0) among them)."""
    x = np.concatenate([[2.0, 8.0, 0.0, 1e-300],
                        np.random.RandomState(0).uniform(0, 100, 10000)])
    got = t_st.sqrt_rn(_t(x)[:, None]).numpy()[:, 0]
    np.testing.assert_array_equal(got, np.sqrt(x))


def test_dilate_matches_jax_per_window():
    """The batched dilation == the JAX pit search's ``_dilate`` on each
    window."""
    from pydem_tpu.ops.pit_growth import _dilate

    masks = np.random.RandomState(2).uniform(size=(3, 9, 11)) < 0.15
    got = t_st.dilate(torch.from_numpy(masks)).numpy()
    for k in range(3):
        want = np.asarray(_dilate(jnp.asarray(masks[k])))
        np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("case", CASES)
def test_seeds_and_edge_todo_matches(chain, case):
    c = chain(case, False)
    want = j_uca.seeds_and_edge_todo(c["W"], c["section"], c["elev"])
    got = t_uca.seeds_and_edge_todo(_t(c["W"]), _t(c["section"]),
                                    _t(c["elev"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _links(case):
    """A few synthetic non-adjacent links (one with weight 0, two into the
    same destination) on the case's canvas."""
    rng = np.random.RandomState(case)
    src = rng.choice(N * N, 12, replace=False)
    dst = rng.choice(N * N, 12, replace=False)
    dst[1] = dst[0]
    w = rng.uniform(0.2, 1.0, 12)
    w[3] = 0.0
    return src.astype("int64"), dst.astype("int64"), w


@pytest.mark.parametrize("pits", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_reachability_matches(chain, case, pits):
    """The downstream flood from a few seeds, with and without pit hops
    (exact: a bool plane)."""
    c = chain(case, False)
    seed = np.zeros((N, N), bool)
    seed[np.random.RandomState(case).randint(0, N, 6),
         np.random.RandomState(case + 1).randint(0, N, 6)] = True
    src, dst, w = _links(case)
    if pits:
        seed.ravel()[src[:4]] = True  # reached sources, one with weight 0
    j_p = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)) if pits else ()
    t_p = (_t(src), _t(dst), _t(w)) if pits else ()
    want = np.asarray(j_uca.reachability(jnp.asarray(seed), c["W"], *j_p))
    got = t_uca.reachability(_t(seed), _t(c["W"]), *t_p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[seed].all()


def test_reachability_pit_hop_rules():
    """With no stencil edges at all, only a reached source with a positive
    weight marks its destination; two links into one pixel do not collide."""
    W = torch.zeros((8, 6, 6), dtype=torch.float64)
    seed = torch.zeros((6, 6), dtype=torch.bool)
    seed[1, 1] = True
    src = torch.tensor([7, 7, 20, 7, 20])     # (1, 1) reached; (3, 2) not
    dst = torch.tensor([14, 15, 30, 33, 14])  # 14 gets a live and a dead link
    w = torch.tensor([1.0, 0.0, 1.0, 0.5, 1.0], dtype=torch.float64)
    got = t_uca.reachability(seed, W, src, dst, w)
    assert sorted(torch.nonzero(got.reshape(-1)).squeeze(1).tolist()) == \
        [7, 14, 33]
    want = j_uca.reachability(jnp.asarray(seed.numpy()),
                              jnp.asarray(W.numpy()), jnp.asarray(src.numpy()),
                              jnp.asarray(dst.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pits", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_accumulate_update_matches(chain, case, pits):
    """The edge-delta propagation with receive and push masks (decimal=10,
    equal sweep counts)."""
    c = chain(case, False)
    rng = np.random.RandomState(case)
    delta0 = np.zeros((N, N))
    delta0[:, 0] = rng.uniform(0, 5, N)
    delta0[0, :] = rng.uniform(0, 5, N)
    edge = np.asarray(j_uca.grid_edge_mask((N, N)))
    receive = (~(edge & (rng.uniform(size=(N, N)) < 0.5))).astype("float64")
    push = (rng.uniform(size=(N, N)) < 0.9).astype("float64")
    src, dst, w = _links(case)
    j_p = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)) if pits else ()
    t_p = (_t(src), _t(dst), _t(w)) if pits else ()
    for pm_j, pm_t in ((None, None), (jnp.asarray(push), _t(push))):
        want, want_n = j_uca.accumulate_update(
            jnp.asarray(delta0), c["W"], jnp.asarray(receive), pm_j, *j_p)
        got, got_n = t_uca.accumulate_update(_t(delta0), _t(c["W"]),
                                             _t(receive), pm_t, *t_p)
        assert got_n == int(want_n)
        np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                             decimal=10)


@pytest.mark.parametrize("shape", [(5, 7), (2, 2), (32, 32)])
def test_grid_edge_mask_matches(shape):
    np.testing.assert_array_equal(t_uca.grid_edge_mask(shape).numpy(),
                                  np.asarray(j_uca.grid_edge_mask(shape)))
