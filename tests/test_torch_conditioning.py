"""pydem_tpu_torch's conditioning == pydem_tpu's (CPU, float64): device flat
filling, the host pit carve (C++ and numpy), and the terrain step with flat
filling.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_hard_terrain
from pydem_tpu import fixtures
from pydem_tpu.core import conditioning as j_cond
from pydem_tpu.core.flats_device import fill_flats_device as j_fill
from pydem_tpu.parallel import sharded as j_sharded
from pydem_tpu_torch import native
from pydem_tpu_torch.core import conditioning as t_cond
from pydem_tpu_torch.core.flats_device import fill_flats_device as t_fill
from pydem_tpu_torch.parallel import sharded as t_sharded

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_flats_device.py's cases: every flat-handling regime
FLAT_CASES = [0, 13, 14, 15, 18, 19, 20, 23, 24, 26, 30, 31, 33]


def _assert_nan_almost_equal(got, want, decimal):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_almost_equal(np.nan_to_num(got),
                                         np.nan_to_num(want), decimal=decimal)


@pytest.mark.parametrize("case", FLAT_CASES)
def test_fill_flats_device_matches_jax(case):
    elev, _a, _u = fixtures.get_test_case(case, 32)
    elev = elev.astype("float64")
    want = np.asarray(j_fill(jnp.asarray(elev)))
    got = t_fill(torch.from_numpy(elev)).numpy()
    _assert_nan_almost_equal(got, want, decimal=10)


def test_fill_flats_device_matches_jax_on_hard_terrain():
    """Quantized noisy cone with a sea notch: pits, peaks, edge flats."""
    elev = make_hard_terrain(128)
    want = np.asarray(j_fill(jnp.asarray(elev)))
    got = t_fill(torch.from_numpy(elev)).numpy()
    assert (got != elev).any()
    _assert_nan_almost_equal(got, want, decimal=10)


@pytest.mark.parametrize("options", [dict(fill_peaks=False),
                                     dict(fill_pits=False, source_tol=0),
                                     dict(maximum_pit_area=0),
                                     dict(below_sea=True)])
def test_fill_flats_device_options_match_jax(options):
    elev, _a, _u = fixtures.get_test_case(30, 32)
    elev = np.round(elev * 40) / 40
    want = np.asarray(j_fill(jnp.asarray(elev), **options))
    got = t_fill(torch.from_numpy(elev), **options).numpy()
    _assert_nan_almost_equal(got, want, decimal=10)


def _carve_cases():
    """tests/test_native_conditioning.py's inputs: (elev, dX, dY, kwargs)."""
    rng = np.random.RandomState(7)
    n = 96
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    yield ("noisy_cone", (1 - np.sqrt(x ** 2 + y ** 2) / np.sqrt(2)) * 5
           + rng.rand(n, n), None, None, {})
    rng = np.random.RandomState(3)
    elev = rng.rand(64, 64) * 4 + 1
    elev[20:30, 20:30] = np.nan
    yield "masked", elev, None, None, {}
    rng = np.random.RandomState(11)
    elev = np.cumsum(rng.rand(48, 48) - 0.45, axis=0) + rng.rand(48, 48)
    yield ("geodesic", elev, 0.8 + 0.4 * np.linspace(0, 1, 47),
           np.full(47, 0.93), {})
    rng = np.random.RandomState(5)
    elev = rng.rand(64, 64) * 3
    for kw in ({"max_dist": 4}, {"max_dist": None}, {"max_dist_XY": 3.0},
               {"max_iter": 5}):
        yield "filters %s" % kw, elev, None, None, kw
    for testnum in (0, 9, 13, 20, 24, 26, 28, 30):
        elev, _a, _u = fixtures.get_test_case(testnum, 16)
        yield ("fixture %d" % testnum,
               j_cond.fill_flats(np.asarray(elev, "float64")), None, None, {})


CARVE_CASES = list(_carve_cases())


@pytest.mark.parametrize("case", CARVE_CASES, ids=[c[0] for c in CARVE_CASES])
def test_drain_pit_paths_matches_jax_bitwise(case):
    _name, elev, dX, dY, kw = case
    n = elev.shape[0]
    dX = np.ones(n - 1) if dX is None else dX
    dY = np.ones(n - 1) if dY is None else dY
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_cond.drain_pit_paths(elev, dX, dY, native=False, **kw)
        got_native = t_cond.drain_pit_paths(elev, dX, dY, native=True, **kw)
        got_numpy = t_cond.drain_pit_paths(elev, dX, dY, native=False, **kw)
    np.testing.assert_array_equal(got_native, want)
    np.testing.assert_array_equal(got_numpy, want)


def test_native_carve_source_is_the_jax_packages():
    """The port's C++ carve is the JAX package's, byte for byte from the
    first include line on (only the header comment names the port)."""
    def code(path):
        text = open(os.path.join(REPO, path), "rb").read()
        return text[text.index(b"\n#include <"):]

    assert code("pydem_tpu_torch/native/conditioning.cpp") == code(
        "pydem_tpu/native/conditioning.cpp")


def test_forced_native_carve_raises_without_gxx(monkeypatch):
    """native=True raises when g++ cannot build the library; native=None
    falls back to the numpy loop."""
    monkeypatch.setattr(native, "_load", _failing_load)
    elev = np.random.RandomState(1).rand(16, 16)
    d = np.ones(15)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            t_cond.drain_pit_paths(elev, d, d, native=True)
        got = t_cond.drain_pit_paths(elev, d, d)
        want = j_cond.drain_pit_paths(elev, d, d, native=False)
    np.testing.assert_array_equal(got, want)


def _failing_load():
    raise RuntimeError("g++ failed on conditioning.cpp")


@pytest.mark.parametrize("case", [30, 13])
def test_terrain_step_fill_flats_matches_jax(case):
    """terrain_step(fill_flats=True) == the JAX step op by op (jitted on the
    CPU, XLA contracts an FMA in the facet sweep: ROADMAP queue 3)."""
    n = 32
    elev, _a, _u = fixtures.get_test_case(case, n)
    elev = np.round(elev * 40) / 40
    ones1, ones = np.ones(n - 1), np.ones(n)
    with jax.disable_jit():
        want = j_sharded.terrain_step(
            jnp.asarray(elev), jnp.asarray(ones1), jnp.asarray(ones1),
            jnp.asarray(ones), jnp.asarray(ones), fill_flats=True)
    t = [torch.from_numpy(a) for a in (elev, ones1, ones1, ones, ones)]
    for solver in ("jacobi", "blocked"):
        got = t_sharded.terrain_step(*t, uca_solver=solver, fill_flats=True)
        np.testing.assert_array_equal(got["flats"].numpy(),
                                      np.asarray(want["flats"]))
        for key in ("mag", "direction", "uca", "twi"):
            _assert_nan_almost_equal(got[key].numpy(), np.asarray(want[key]),
                                     decimal=10)
    plain = t_sharded.terrain_step(*t)
    assert not torch.equal(torch.nan_to_num(plain["uca"]),
                           torch.nan_to_num(got["uca"]))
