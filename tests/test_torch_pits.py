"""pydem_tpu_torch's pit links == pydem_tpu's (CPU, float64): the device pit
search (``pit_links_device_packed``, both window tiers), and the Jacobi
solve with pit links, whose deterministic fold (``PitLinks``) sums in the
JAX package's order.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_hard_terrain
from pydem_tpu import DEMProcessor, fixtures
from pydem_tpu.core import conditioning as j_cond
from pydem_tpu.core.receivers import receiver_weights, section_proportion
from pydem_tpu.core.uca import accumulate as j_accumulate
from pydem_tpu.core.uca import base_area
from pydem_tpu.ops.pit_growth import pit_links_device_packed as j_links
from pydem_tpu_torch.core.uca import PitLinks
from pydem_tpu_torch.core.uca import accumulate as t_accumulate
from pydem_tpu_torch.ops.pit_growth import pit_links_device_packed as t_links

torch.set_num_threads(1)


def _pit_state(elev):
    """flats/elev/dX/dY with the pits left in (no conditioning), from the JAX
    package's host path; both packages get the same arrays."""
    dp = DEMProcessor(elev=elev, fill_flats=False, drain_pits_path=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp.calc_slopes_directions()
    assert (dp.flats & (dp.elev > 0)).any()  # the input has pits
    return dp.flats, dp.elev, dp.dX, dp.dY


def _long_channel(n=128, drain_col=44):
    """tests/test_pit_growth.py's channel: the pit's growth frontier wanders
    ``drain_col - 4`` px before it finds a lower drain."""
    elev = np.full((n, n), 10.0)
    row, c0 = n // 2, 4
    elev[row, c0] = 1.0
    ks = np.arange(1, drain_col - c0)
    elev[row, c0 + ks] = 1.0 + 0.001 * ks
    elev[row, drain_col] = 0.5
    flats = np.zeros((n, n), bool)
    flats[row, c0] = True
    return flats, elev, np.ones(n - 1), np.ones(n - 1)


def _case(name):
    """(flats, elev, dX, dY), kwargs for a case of the link tests."""
    if name.startswith("fixture"):
        return _pit_state(fixtures.get_test_case(int(name.split()[1]),
                                                 32)[0]), {}
    if name == "hard 128":
        return _pit_state(make_hard_terrain(128)), {}
    if name == "channel retry":
        # the two-tier retry of tests/test_pit_growth.py:73: tier 1 clips
        return _long_channel(), dict(max_iter=300, max_dist=300,
                                     first_window=16, window=96)
    assert name == "options"
    return _pit_state(fixtures.get_test_case(13, 32)[0]), dict(
        min_border=True, max_dist_XY=3.0)


@pytest.mark.parametrize("name", ["fixture 13", "fixture 16", "hard 128",
                                  "channel retry", "options"])
def test_pit_links_match_jax(name):
    (flats, elev, dX, dY), kw = _case(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_links(jnp.asarray(flats), jnp.asarray(elev), dX, dY, **kw)
    got = t_links(torch.tensor(flats), torch.tensor(elev), dX, dY, **kw)
    # the JAX link arrays are padded to a bucket with zero-weight entries
    w = np.asarray(want["wgt"])
    j_src, j_dst, j_w = (np.asarray(want["src"])[w > 0],
                         np.asarray(want["dst"])[w > 0], w[w > 0])
    t_src, t_dst, t_w = (got[k].numpy() for k in ("src", "dst", "wgt"))
    assert got["n_links"] == t_src.size == j_src.size > 0
    jo, to = np.lexsort((j_dst, j_src)), np.lexsort((t_dst, t_src))
    np.testing.assert_array_equal(t_src[to], j_src[jo])
    np.testing.assert_array_equal(t_dst[to], j_dst[jo])
    np.testing.assert_array_almost_equal(t_w[to], j_w[jo], decimal=10)

    N = elev.size
    j_idx = np.asarray(want["drained_idx"])
    t_idx = got["drained_idx"].numpy()
    # drained pits and their magnitudes, keyed by pit (the sentinel N marks
    # a pit that did not drain)
    j_mag = dict(zip(j_idx[j_idx < N],
                     np.asarray(want["drained_mag"])[j_idx < N]))
    t_mag = dict(zip(t_idx[t_idx < N],
                     got["drained_mag"].numpy()[t_idx < N]))
    assert sorted(t_mag) == sorted(j_mag)
    np.testing.assert_array_almost_equal(
        [t_mag[k] for k in sorted(t_mag)], [j_mag[k] for k in sorted(j_mag)],
        decimal=10)
    assert got["n_warn"] == want["n_warn"]


def test_pit_links_none_without_pits():
    elev = np.add.outer(np.arange(16.0), np.arange(16.0)) + 1
    flats = np.zeros((16, 16), bool)
    d = np.ones(15)
    assert t_links(torch.from_numpy(flats), torch.from_numpy(elev), d, d) \
        is None


def _uca_inputs(case):
    """W, base and the host pit links of a fixture with its pits left in
    (tests/test_uca_block.py's setup)."""
    elev, _a, _u = fixtures.get_test_case(case, 32)
    dp = DEMProcessor(elev=elev, fill_flats=False, drain_pits_path=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp.calc_slopes_directions()
        ps, pd, pw, _flats, _mag = j_cond.connectivity_pits(
            dp.flats, dp.elev, dp.mag, dp.dX, dp.dY)
    keep = pw > 1e-8
    section, proportion = section_proportion(
        jnp.asarray(dp.direction), jnp.asarray(dp.flats),
        jnp.asarray(dp.dX), jnp.asarray(dp.dY))
    W = receiver_weights(section, proportion, jnp.asarray(dp.elev))
    base = base_area(jnp.asarray(dp.dX2), jnp.asarray(dp.dY2), elev.shape,
                     jnp.float64)
    return W, base, ps[keep], pd[keep], pw[keep]


@pytest.mark.parametrize("case", [13, 16])
def test_jacobi_with_pit_links_matches_jax(case):
    W, base, ps, pd, pw = _uca_inputs(case)
    want, want_sweeps = j_accumulate(base, W, jnp.asarray(ps),
                                     jnp.asarray(pd), jnp.asarray(pw))
    got, sweeps = t_accumulate(
        torch.tensor(np.asarray(base)), torch.tensor(np.asarray(W)),
        torch.from_numpy(ps), torch.from_numpy(pd), torch.from_numpy(pw))
    assert sweeps == int(want_sweeps)
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


def test_pit_fold_is_a_sequential_sum_in_link_order():
    """PitLinks.add_to adds each destination's contributions one by one in
    link order, bitwise like np.add.at, however the links are ordered."""
    rng = np.random.RandomState(4)
    n_px, n_links = 50, 400
    src = rng.randint(0, n_px, n_links)
    dst = rng.randint(0, 12, n_links)  # many links per destination
    w = rng.uniform(0, 1, n_links)
    x = rng.uniform(1, 1e3, n_px)
    out = rng.uniform(0, 1, n_px)
    want = out.copy()
    np.add.at(want, dst, x[src] * w)
    links = PitLinks(torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(w))
    assert links.width == np.bincount(dst).max()
    got = links.add_to(torch.from_numpy(out), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    empty = PitLinks(*(torch.zeros(0, dtype=t) for t in (torch.int64,
                                                         torch.int64,
                                                         torch.float64)))
    assert torch.equal(empty.add_to(torch.from_numpy(out),
                                    torch.from_numpy(x)),
                       torch.from_numpy(out))


def _link_set(src, dst, wgt):
    order = np.lexsort((dst, src))
    return src[order], dst[order], wgt[order]


@pytest.mark.parametrize("name", ["fixture 13", "fixture 16", "hard 128",
                                  "options"])
def test_pit_links_device_match_jax_and_host(name):
    """``pit_links_device`` and ``connectivity_pits_device`` give the link
    set of the JAX package's device search, and of the host search
    (``connectivity_pits``) where no pit's search leaves its window: equal
    sources and destinations, weights and magnitudes to ``decimal=10``."""
    from pydem_tpu.ops.pit_growth import connectivity_pits_device as j_cpd
    from pydem_tpu_torch.core.conditioning import connectivity_pits
    from pydem_tpu_torch.ops.pit_growth import (connectivity_pits_device,
                                                 pit_links_device)

    (flats, elev, dX, dY), kw = _case(name)
    mag = np.where(flats, -1.0, 0.25)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_cpd(flats, elev, mag, dX, dY, **kw)
        host = connectivity_pits(flats, elev, mag, dX, dY, **kw)
        got = connectivity_pits_device(flats, elev, mag, dX, dY,
                                       device="cpu", **kw)
        raw = pit_links_device(torch.tensor(flats), torch.tensor(elev), dX,
                               dY, **kw)
    assert got[0].size > 0 and got[0].dtype == np.int64
    for other in (want, host):
        for g, o in zip(_link_set(*got[:3]), _link_set(*other[:3])):
            np.testing.assert_array_almost_equal(g, np.asarray(o), decimal=10)
        np.testing.assert_array_equal(got[3], np.asarray(other[3]))  # flats
        np.testing.assert_array_almost_equal(got[4], np.asarray(other[4]),
                                             decimal=10)             # mag
    for g, r in zip(got[:3], raw[:3]):
        np.testing.assert_array_equal(g, r)
    assert not got[3].ravel()[raw[3]].any()  # drained pits left the flats
    np.testing.assert_array_equal(got[4].ravel()[raw[3]], raw[4])
    assert flats.ravel()[raw[3]].all() and mag[0, 0] == got[4][0, 0]


def test_pit_links_device_without_pits_and_warning():
    from pydem_tpu_torch.ops.pit_growth import pit_links_device

    elev = np.add.outer(np.arange(16.0), np.arange(16.0)) + 1
    d = np.ones(15)
    out = pit_links_device(torch.zeros((16, 16), dtype=torch.bool),
                           torch.from_numpy(elev), d, d)
    assert [a.size for a in out] == [0] * 5
    # a pit in a closed basin deeper than max_iter growth steps: no drain
    bowl = np.full((16, 16), 9.0)
    bowl[8, 8] = 1.0
    flats = np.zeros((16, 16), bool)
    flats[8, 8] = True
    with pytest.warns(UserWarning, match="no place to drain"):
        out = pit_links_device(torch.from_numpy(flats),
                               torch.from_numpy(bowl), d, d, max_iter=2)
    assert out[0].size == 0 and out[3].size == 0


def test_connectivity_pits_device_defaults_to_the_card():
    """The drop-in for the JAX function, which runs on the default backend,
    runs on the GPU unless the CPU is asked for: without one it raises."""
    from pydem_tpu_torch.ops.pit_growth import connectivity_pits_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    (flats, elev, dX, dY), kw = _case("fixture 13")
    mag = np.where(flats, -1.0, 0.25)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        connectivity_pits_device(flats, elev, mag, dX, dY, **kw)
