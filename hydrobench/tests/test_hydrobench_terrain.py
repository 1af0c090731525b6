"""The seeded terrain generator, the harness's fill and its spacings."""
import numpy as np
import pytest
import torch

from hydrobench import geo
from hydrobench.terrain import fill, fractal

BASIN = {"pool": 8, "terrain": {"kind": "fractal", "surface_seed": 1,
                                "hurst": 0.8, "relief_m": 600, "tilt_m": 400,
                                "base_m": 100, "fill_eps_m": 0.001}}
COAST = {"pool": 8, "terrain": {"kind": "fractal", "surface_seed": 2,
                                "hurst": 0.8, "relief_m": 600, "tilt_m": 20,
                                "base_m": 0,
                                "sea_share": 0.5, "fill_eps_m": 0.001}}
CONFIG = {"shape": [80, 80], "dtype": "float32"}


def _pits(tile):
    t = torch.from_numpy(np.asarray(tile, "float64"))
    sea = torch.isnan(t)
    return fill.interior_pits(torch.where(sea, 0.0, t), sea)


@pytest.mark.parametrize("traffic", [BASIN, COAST], ids=["basin", "coast"])
def test_filled_tiles_have_no_interior_pit(traffic):
    pool, order = fractal.make_pool(traffic, CONFIG, 2 ** 35 + 11, "cpu")
    assert sorted(order) == list(range(8))
    raw = fractal.spectral_surface((80, 80), 0.8, fractal.generator(1, "cpu"),
                                   "cpu")
    assert fill.interior_pits(raw.double()) > 0  # a fill has work
    for tile in pool:  # the 8 rotations and flips: each still pit-free
        assert tile.dtype == np.float32
        assert _pits(tile) == 0


def test_flips_and_rotations_keep_a_fill():
    z, sea = fractal.surface(BASIN, (64, 64), fractal.generator(5, "cpu"),
                             "cpu")
    assert fill.interior_pits(z.double(), sea) == 0
    for k in range(8):
        zk = fractal.dihedral(z, k)
        assert fill.interior_pits(zk.double(), fractal.dihedral(sea, k)) == 0
        assert torch.equal(torch.sort(zk.reshape(-1))[0],
                           torch.sort(z.reshape(-1))[0])


def test_coast_is_half_sea_as_nodata():
    pool, _ = fractal.make_pool(COAST, CONFIG, 9, "cpu")
    for tile in pool:
        assert 0.45 < np.isnan(tile).mean() < 0.55


def test_same_tiles_for_every_seed_in_another_order():
    a, oa = fractal.make_pool(BASIN, CONFIG, 2 ** 40 + 1, "cpu")
    b, ob = fractal.make_pool(BASIN, CONFIG, 2 ** 40 + 1, "cpu")
    c, oc = fractal.make_pool(BASIN, CONFIG, 2 ** 40 + 2, "cpu")
    assert oa == ob and oa != oc and sorted(oc) == sorted(oa)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(a, c))
    other = dict(BASIN, terrain=dict(BASIN["terrain"], surface_seed=9))
    d, _ = fractal.make_pool(other, CONFIG, 2 ** 40 + 1, "cpu")
    assert not np.array_equal(a[0], d[0])


def test_epsilon_fill_drops_eps_a_pixel():
    e = torch.full((5, 5), 10.0, dtype=torch.float64)
    e[1:-1, 1:-1] = 1.0
    e[2, 2] = -3.0  # a pit
    e[2, 0] = 0.0  # the outlet on the west rim
    w = fill.epsilon_fill(e, eps=0.5)
    assert fill.interior_pits(e) > 0 and fill.interior_pits(w) == 0
    assert w[2, 1] == 1.0 and w[2, 2] == 1.5 and w[2, 3] == 2.0
    assert torch.all(w >= e)


def test_spacings_on_the_ellipsoid():
    # 1 arc-second at 45 N: 30.87 m north-south, 21.90 m east-west
    assert geo.north_south_m(45.0, 1 / 3600) == pytest.approx(30.87, abs=0.01)
    assert geo.east_west_m(45.0, 1 / 3600) == pytest.approx(21.90, abs=0.01)
    cfg = {"shape": [3601, 3601], "geometry": {
        "north": 46.0, "step_arcsec": 1, "first_row_offset": 0}}
    dX, dY, dX2, dY2 = geo.tile_spacings(cfg)
    assert dX.shape == dY.shape == (3600,) and dX2.shape == (3601,)
    assert np.all(np.diff(dX) > 0)  # rows run south, parallels lengthen
    assert dX2[0] == pytest.approx(geo.east_west_m(46.0, 1 / 3600))
