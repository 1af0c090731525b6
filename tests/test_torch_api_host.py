"""pydem_tpu_torch.DEMProcessor's host-state route == pydem_tpu's (CPU,
float64): the default (host) backends, the three drain modes, raster input,
save/load, ``edge_done`` and the tile edge update
(``calc_uca(uca_init=..., edge_init_data=...)``).

Tolerances: integer and bool planes (flats, section, edge_todo, edge_done)
exact; elevation exact (the conditioning is the same numpy code); mag,
direction, uca and twi ``decimal=10``; sweep counts and ``twi_min_area``
equal.  Where the JAX chain is jitted and XLA's FMA contraction in the facet
sweep flips a near-tie facet (ROADMAP queue 3: fixtures 13, 16 and 33 at
32²), it runs op by op under ``jax.disable_jit()``.  With geodesic pixel
sizes the areas are ~1e8 m², so that case compares relatively (1e-13).
"""
import contextlib
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from pydem_tpu import DEMProcessor as JaxDEMProcessor
from pydem_tpu import fixtures
from pydem_tpu.geometry import mk_transform
from pydem_tpu.io import write_geotiff
from pydem_tpu_torch.api import DEMProcessor
from pydem_tpu_torch.convert import (processor_from_state, processor_state,
                                     state_from_numpy)

torch.set_num_threads(1)

DECIMAL = 10
OP_BY_OP = ("fixture 13", "fixture 16", "fixture 33")


def _elev(name):
    if name == "fixture 30 quantized":  # as tests/test_api.py:110-111
        elev, _a, _u = fixtures.get_test_case(30, 64)
        return np.round(np.asarray(elev) * 40) / 40
    return np.asarray(fixtures.get_test_case(int(name.split()[1]), 32)[0])


def _jit_ctx(name):
    return jax.disable_jit() if name in OP_BY_OP else contextlib.nullcontext()


def _close(got, want, msg, decimal=DECIMAL):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
    np.testing.assert_array_almost_equal(np.nan_to_num(got),
                                         np.nan_to_num(want), decimal=decimal,
                                         err_msg=msg)


def _same_state(got, want, msg=""):
    np.testing.assert_array_equal(got.elev, want.elev, err_msg=msg + " elev")
    for key in ("flats", "section", "edge_todo", "edge_done"):
        np.testing.assert_array_equal(np.asarray(getattr(got, key)),
                                      np.asarray(getattr(want, key)),
                                      err_msg="%s %s" % (msg, key))
    for key in ("mag", "direction", "proportion", "uca", "twi"):
        _close(getattr(got, key), getattr(want, key), "%s %s" % (msg, key))
    assert got.uca_sweeps == want.uca_sweeps
    assert got.twi_min_area == want.twi_min_area


def _run_both(name, **kw):
    elev = _elev(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _jit_ctx(name):
            want = JaxDEMProcessor(elev=elev.copy(), **kw)
            want_twi = want.calc_twi()
            want.edge_done
        got = DEMProcessor(elev=elev.copy(), device="cpu", **kw)
        got_twi = got.calc_twi()
    _close(got_twi, want_twi, name + " calc_twi")
    return got, want


@pytest.mark.parametrize("name", ["fixture 30 quantized", "fixture 13",
                                  "fixture 16", "fixture 31", "fixture 33"])
def test_host_backends_match_jax(name):
    """The default configuration: host conditioning, host pit search, the
    stencil programs on the device, numpy state between the stages."""
    got, want = _run_both(name)
    assert got._dev("uca") is None  # host state, not the device chain
    _same_state(got, want, name)


@pytest.mark.parametrize("mode", ["drain_pits", "drain_flats",
                                  "drain_pits_spill", "none"])
def test_drain_modes_match_jax(mode):
    """The mode precedence drain_pits → drain_flats → drain_pits_spill, on
    terrain that keeps pits after conditioning."""
    kw = dict(drain_pits=mode == "drain_pits",
              drain_flats=mode == "drain_flats",
              drain_pits_spill=mode == "drain_pits_spill")
    got, want = _run_both("fixture 30 quantized", **kw)
    _same_state(got, want, mode)


def test_drain_mode_precedence():
    """drain_pits wins over the other two, drain_flats over spill."""
    elev = _elev("fixture 30 quantized")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = DEMProcessor(elev=elev.copy(), device="cpu")
        ref.calc_uca()
        both = DEMProcessor(elev=elev.copy(), device="cpu", drain_flats=True,
                            drain_pits_spill=True)
        both.calc_uca()
        flats = DEMProcessor(elev=elev.copy(), device="cpu", drain_pits=False,
                             drain_flats=True)
        flats.calc_uca()
        fs = DEMProcessor(elev=elev.copy(), device="cpu", drain_pits=False,
                          drain_flats=True, drain_pits_spill=True)
        fs.calc_uca()
    np.testing.assert_array_equal(both.uca, ref.uca)
    np.testing.assert_array_equal(fs.uca, flats.uca)


@pytest.mark.parametrize("cond,pit", [("host", "device"), ("device", "host")])
def test_mixed_backends_match_jax(cond, pit):
    """One backend on the device, the other on the host: the host-state
    route with ``connectivity_pits_device`` or ``fill_flats_device``."""
    got, want = _run_both("fixture 30 quantized", conditioning_backend=cond,
                          pit_backend=pit)
    assert got._dev("uca") is None
    _same_state(got, want, "%s/%s" % (cond, pit))


def test_stagewise_device_backends_match_the_chain():
    """calc_fill_flats + calc_pit_drain_paths + calc_slopes_directions +
    calc_uca, stage by stage as ProcessManager calls them, land where the
    one-call device chain lands."""
    elev = _elev("fixture 30 quantized")
    kw = dict(conditioning_backend="device", pit_backend="device",
              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chain = DEMProcessor(elev=elev.copy(), **kw)
        chain.calc_twi()
        dp = DEMProcessor(elev=elev.copy(), **kw)
        dp.calc_fill_flats()
        dp.calc_pit_drain_paths()
        dp.fill_flats = dp.drain_pits_path = False
        dp.calc_slopes_directions()
        dp.calc_uca()
        dp.calc_twi()
    np.testing.assert_array_equal(dp.elev, chain.elev)
    np.testing.assert_array_equal(dp.flats, chain.flats)
    _close(dp.uca, chain.uca, "uca", decimal=12)
    _close(dp.twi, chain.twi, "twi", decimal=12)
    np.testing.assert_array_equal(dp.edge_done, chain.edge_done)


def test_device_chain_edge_done_matches_jax():
    """edge_done after a device-chain solve floods through the links the
    solve used."""
    elev = _elev("fixture 30 quantized")
    kw = dict(conditioning_backend="device", pit_backend="device")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxDEMProcessor(elev=elev.copy(), **kw)
        want.calc_uca()
        got = DEMProcessor(elev=elev.copy(), device="cpu", **kw)
        got.calc_uca()
    assert got._dev("uca") is not None
    np.testing.assert_array_equal(got.edge_todo, np.asarray(want.edge_todo))
    np.testing.assert_array_equal(got.edge_done, np.asarray(want.edge_done))


def test_edge_done_no_data_and_limit_edges():
    """No-data pixels are always done; ``apply_uca_limit_edges`` marks
    saturated pixels done; the setter overrides the flood."""
    elev = _elev("fixture 33").copy()
    elev[10:14, 20:24] = np.nan
    for kw in ({}, {"apply_uca_limit_edges": True, "uca_saturation_limit": 2}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = JaxDEMProcessor(elev=elev.copy(), **kw)
            want.calc_uca()
            got = DEMProcessor(elev=elev.copy(), device="cpu", **kw)
            got.calc_uca()
        np.testing.assert_array_equal(got.edge_done,
                                      np.asarray(want.edge_done))
        assert got.edge_done[11, 21]
    got.edge_done = np.zeros(elev.shape, bool)
    assert not got.edge_done.any()
    fresh = DEMProcessor(elev=elev, device="cpu")
    assert fresh.edge_done is None  # nothing solved yet


def test_elev_fn_reads_a_raster(tmp_path):
    """``DEMProcessor(elev_fn)``: pixel vectors, bounds and transform come
    from the file, in both packages alike."""
    n = 32
    elev = _elev("fixture 33")
    fn = str(tmp_path / "elev.tif")
    write_geotiff(fn, np.asarray(elev, "float64"),
                  mk_transform(46.0, -73.0, -1.0 / n, 1.0 / n,
                               lat_lon_centered=False))
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        want = JaxDEMProcessor(fn)
        want.calc_twi()
        got = DEMProcessor(fn, device="cpu")
        got.calc_twi()
    for key in ("dX", "dY", "dX2", "dY2"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert tuple(got.bounds) == tuple(want.bounds)
    assert tuple(got.transform) == tuple(want.transform)
    assert got.get_fn("uca") == want.get_fn("uca")
    assert got.get_full_fn("uca", "r") == want.get_full_fn("uca", "r")
    np.testing.assert_allclose(got.uca, want.uca, rtol=1e-13)
    _close(got.twi, want.twi, "twi")
    with pytest.raises(ValueError, match="no bounds"):
        DEMProcessor(elev=elev, device="cpu").get_fn()


def test_save_and_load_arrays(tmp_path):
    """save_array/load_array and the load_* helpers; files written by one
    package load in the other."""
    elev = _elev("fixture 13")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = DEMProcessor(elev=elev, device="cpu")
        dp.calc_twi()
    for name in ("elev", "mag", "direction", "uca"):
        dp.save_array(str(tmp_path / name), name)
    other = DEMProcessor(elev=np.zeros_like(elev), device="cpu")
    other.load_elevation(str(tmp_path / "elev"))
    other.load_slope(str(tmp_path / "mag"))
    other.load_direction(str(tmp_path / "direction"))
    other.load_uca(str(tmp_path / "uca"))
    jx = JaxDEMProcessor(elev=np.zeros_like(elev))
    jx.load_uca(str(tmp_path / "uca"))
    for name in ("elev", "mag", "direction", "uca"):
        np.testing.assert_array_equal(getattr(other, name), getattr(dp, name))
    np.testing.assert_array_equal(jx.uca, dp.uca)
    other.find_flats()
    np.testing.assert_array_equal(other.flats, dp.mag == -1)
    with pytest.raises(RuntimeError, match="does not exist"):
        other.load_array(str(tmp_path / "nothing"), "uca")
    # a loaded state goes on: TWI from the loaded uca and slope
    other.twi_min_area = dp.twi_min_area
    _close(other.calc_twi(), dp.twi / 10, "twi from loaded state")


# -- the tile edge update ---------------------------------------------------

N, CUT = 32, 14
NOCOND = dict(fill_flats=False, drain_pits_path=False)
SIDE_SLICE = {"left": (slice(None), 0), "right": (slice(None), -1),
              "top": (0, slice(None)), "bottom": (-1, slice(None))}


def _edge_dicts(shape):
    n, m = shape
    sizes = [("left", n), ("right", n), ("top", m), ("bottom", m)]
    return ({k: np.zeros(s, "float64") for k, s in sizes},
            {k: np.zeros(s, bool) for k, s in sizes},
            {k: np.zeros(s, bool) for k, s in sizes})


def _fresh(elev, impl):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = (JaxDEMProcessor(elev=elev.copy(), **NOCOND) if impl == "jax"
              else DEMProcessor(elev=elev.copy(), device="cpu", **NOCOND))
        dp.calc_slopes_directions()
        dp.calc_uca()
    return dp


def _update(elev, uca0, edge_init, impl):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = (JaxDEMProcessor(elev=elev.copy(), **NOCOND) if impl == "jax"
              else DEMProcessor(elev=elev.copy(), device="cpu", **NOCOND))
        dp.calc_slopes_directions()
        out = dp.calc_uca(uca_init=uca0.copy(), edge_init_data=edge_init)
    return np.asarray(out, "float64"), dp


@pytest.fixture(scope="module")
def noisy_cone():
    """Fixture 31 (a noisy cone: no exact facet ties) and its full-canvas
    UCA, which provides the edge data of every tile cut from it."""
    elev = np.asarray(fixtures.get_test_case(31, N)[0])
    return elev, np.asarray(_fresh(elev, "jax").uca, "float64")


@pytest.mark.parametrize("side", ["left", "right", "top", "bottom"])
def test_edge_update_matches_jax_on_every_side(noisy_cone, side):
    elev, full_uca = noisy_cone
    tile = {"left": elev[:, CUT:], "right": elev[:, :CUT + 1],
            "top": elev[CUT:, :], "bottom": elev[:CUT + 1, :]}[side]
    strip = np.nan_to_num(full_uca[:, CUT] if side in ("left", "right")
                          else full_uca[CUT, :])

    want0, got0 = _fresh(tile, "jax"), _fresh(tile, "torch")
    _close(got0.uca, want0.uca, "fresh uca (%s)" % side)
    np.testing.assert_array_equal(got0.edge_todo, np.asarray(want0.edge_todo))

    data, done, todo = _edge_dicts(tile.shape)
    data[side] = strip
    done[side][:] = True
    todo[side][:] = np.asarray(want0.edge_todo)[SIDE_SLICE[side]]

    want, want_dp = _update(tile, np.asarray(want0.uca, "float64"),
                            [data, done, todo], "jax")
    got, got_dp = _update(tile, np.asarray(got0.uca, "float64"),
                          [data, done, todo], "torch")
    _close(got, want, "updated uca (%s)" % side)
    assert np.abs(np.nan_to_num(got - np.asarray(got0.uca))).max() > 0
    np.testing.assert_array_equal(got_dp.edge_done,
                                  np.asarray(want_dp.edge_done))
    np.testing.assert_array_equal(got_dp.edge_todo,
                                  np.asarray(want_dp.edge_todo, bool))
    np.testing.assert_array_equal(got_dp.flats, np.asarray(want_dp.flats))


def test_edge_update_two_chained_rounds(noisy_cone):
    """Partial edge data first, the rest later: the done∧todo bookkeeping
    round over round, landing on the full-canvas solve in the interior."""
    elev, full_uca = noisy_cone
    tile = elev[:, CUT:]
    strip = np.nan_to_num(full_uca[:, CUT])
    want0, got0 = _fresh(tile, "jax"), _fresh(tile, "torch")
    n = tile.shape[0]
    half1 = np.zeros(n, bool)
    half1[: n // 2] = True
    todo0 = np.asarray(want0.edge_todo)[:, 0]

    data, done, todo = _edge_dicts(tile.shape)
    data["left"], done["left"], todo["left"] = (strip * half1, half1.copy(),
                                                todo0.copy())
    want1, want_p1 = _update(tile, np.asarray(want0.uca, "float64"),
                             [data, done, todo], "jax")
    got1, got_p1 = _update(tile, np.asarray(got0.uca, "float64"),
                           [data, done, todo], "torch")
    _close(got1, want1, "round-1 uca")
    np.testing.assert_array_equal(got_p1.edge_done,
                                  np.asarray(want_p1.edge_done))
    np.testing.assert_array_equal(got_p1.edge_todo,
                                  np.asarray(want_p1.edge_todo, bool))

    data2, done2, todo2 = _edge_dicts(tile.shape)
    data2["left"], done2["left"] = strip * ~half1, ~half1
    todo2["left"] = np.asarray(want_p1.edge_todo)[:, 0]
    want2, want_p2 = _update(tile, want1, [data2, done2, todo2], "jax")
    got2, got_p2 = _update(tile, got1, [data2, done2, todo2], "torch")
    _close(got2, want2, "round-2 uca")
    np.testing.assert_array_equal(got_p2.edge_done,
                                  np.asarray(want_p2.edge_done))
    _close(got2[1:-1, 1:-1], full_uca[:, CUT:][1:-1, 1:-1],
           "chained rounds vs the full canvas", decimal=8)


def test_edge_update_with_pit_links():
    """The update with pit links in the graph (quantized terrain, default
    conditioning): the delta passes through ``PitLinks``."""
    elev = _elev("fixture 30 quantized")
    tile = elev[:, 30:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = JaxDEMProcessor(elev=elev.copy())
        full.calc_uca()
        want0 = JaxDEMProcessor(elev=tile.copy())
        want0.calc_uca()
        got0 = DEMProcessor(elev=tile.copy(), device="cpu")
        got0.calc_uca()
        data, done, todo = _edge_dicts(tile.shape)
        data["left"] = np.nan_to_num(np.asarray(full.uca)[:, 30])
        done["left"][:] = True
        todo["left"][:] = np.asarray(want0.edge_todo)[:, 0]
        want = np.asarray(want0.calc_uca(
            uca_init=np.asarray(want0.uca, "float64").copy(),
            edge_init_data=[data, done, todo]))
        got = got0.calc_uca(uca_init=np.asarray(got0.uca, "float64").copy(),
                            edge_init_data=[data, done, todo])
    _close(got, want, "updated uca with pit links")
    np.testing.assert_array_equal(got0.edge_done, np.asarray(want0.edge_done))


@pytest.mark.parametrize("stage", ["slopes", "uca"])
def test_processor_from_a_jax_state(stage):
    """A JAX processor's state after a stage sets up the port's processor
    at the same point (``convert.processor_from_state``)."""
    elev = _elev("fixture 31")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxDEMProcessor(elev=elev.copy())
        want.calc_slopes_directions()
        if stage == "uca":
            want.calc_uca()
            want.edge_done
        state = processor_state(want)
        got = processor_from_state(state, device="cpu", fill_flats=False,
                                   drain_pits_path=False)
        np.testing.assert_array_equal(got.direction, want.direction)
        if stage == "uca":
            assert got.uca_sweeps == want.uca_sweeps
            assert got.twi_min_area == want.twi_min_area
            np.testing.assert_array_equal(got.edge_done, want.edge_done)
        else:
            assert got.uca is None
        _close(got.calc_twi(), want.calc_twi(), "twi from the carried state")
    tensors = state_from_numpy(state, "cpu", torch.float64)
    assert tensors["flats"].dtype == torch.bool
    assert isinstance(tensors["uca_sweeps"], int)
    assert (tensors["uca"] is None) == (stage == "slopes")
