"""pydem_tpu_torch.DEMProcessor's device chain == pydem_tpu's (CPU, float64).
(The host-state route is held in ``tests/test_torch_api_host.py``.)

Both run with ``conditioning_backend="device", pit_backend="device"``: flat
filling, the pit gate and carve, slope/flats/section, pit links, the UCA
fixed point (the port's jacobi, and its blocked solver with the plain K1
round) and TWI.  On fixtures 13 and 16 the JAX chain runs op by op
(``jax.disable_jit()``): jitted on the CPU, XLA contracts an FMA in the
facet sweep and flips a near-tie facet (ROADMAP queue 3).
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from pydem_tpu import DEMProcessor as JaxDEMProcessor
from pydem_tpu import fixtures
from pydem_tpu.api import _has_pits_program as j_has_pits
from pydem_tpu_torch import api
from pydem_tpu_torch.api import DEMProcessor

torch.set_num_threads(1)

CHAIN = dict(conditioning_backend="device", pit_backend="device")
DEVICE = dict(CHAIN, device="cpu")


def _elev(name):
    if name == "fixture 30 quantized":  # as tests/test_api.py:110-111
        elev, _a, _u = fixtures.get_test_case(30, 64)
        return np.round(np.asarray(elev) * 40) / 40
    return fixtures.get_test_case(int(name.split()[1]), 32)[0]


@pytest.mark.parametrize("name", ["fixture 30 quantized", "fixture 13",
                                  "fixture 16"])
def test_device_chain_matches_jax(name):
    elev = _elev(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name.endswith("quantized"):
            want = JaxDEMProcessor(elev=elev.copy(), **CHAIN)
            want_twi = want.calc_twi()
        else:
            with jax.disable_jit():
                want = JaxDEMProcessor(elev=elev.copy(), **CHAIN)
                want_twi = want.calc_twi()
        for solver in ("jacobi", "blocked"):
            got = DEMProcessor(elev=elev.copy(), uca_solver=solver, **DEVICE)
            got_twi = got.calc_twi()
            assert got._dev("uca") is not None  # the device chain ran
            np.testing.assert_array_equal(got.flats, want.flats)
            for key, g, w in (("uca", got.uca, want.uca),
                              ("twi", got.twi, want.twi),
                              ("mag", got.mag, want.mag),
                              ("calc_twi", got_twi, want_twi)):
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                              err_msg=key)
                np.testing.assert_array_almost_equal(
                    np.nan_to_num(g), np.nan_to_num(w), decimal=8,
                    err_msg="%s %s" % (solver, key))
            if solver == "jacobi":
                assert got.uca_sweeps == want.uca_sweeps
            else:
                assert 1 <= got.uca_sweeps < want.uca_sweeps
            assert got.twi_min_area == want.twi_min_area


@pytest.mark.parametrize("name", ["fixture 13", "fixture 16", "fixture 33"])
def test_blocked_solver_matches_jax_blocked(name):
    """``uca_solver="blocked"`` with ``uca_block_size=8`` against the JAX
    ``DEMProcessor`` with the same options (its Pallas Gauss-Seidel solver in
    interpret mode; op by op, as above): K1's rounds in the TPU's order give
    the JAX round count, and uca and twi agree."""
    elev = _elev(name)
    kw = dict(CHAIN, uca_solver="blocked", uca_block_size=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax.disable_jit():
            want = JaxDEMProcessor(elev=elev.copy(), **kw)
            want_twi = want.calc_twi()
        got = DEMProcessor(elev=elev.copy(), device="cpu", **kw)
        got_twi = got.calc_twi()
    assert got._dev("uca") is not None  # the device chain ran
    np.testing.assert_array_equal(got.flats, want.flats)
    for key, g, w in (("uca", got.uca, want.uca), ("twi", got.twi, want.twi),
                      ("calc_twi", got_twi, want_twi)):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        np.testing.assert_array_almost_equal(
            np.nan_to_num(g), np.nan_to_num(w), decimal=8, err_msg=key)
    assert got.uca_sweeps == int(want.uca_sweeps) >= 2


def test_state_stays_on_the_device_until_read():
    elev = _elev("fixture 13")
    dp = DEMProcessor(elev=elev, **DEVICE)
    twi = dp.calc_twi()
    assert isinstance(dp._dev("twi"), torch.Tensor)  # TWI on the device
    assert dp.__dict__.get("_np_flats") is None
    assert dp.flats.dtype == bool  # fetched on first read, then cached
    assert dp.__dict__["_np_flats"] is dp.flats
    assert dp.edge_todo.shape == elev.shape
    # calc_uca returns the fetched uca; TWI then takes the host formula on
    # the (editable) numpy views, with the same result
    dp2 = DEMProcessor(elev=elev, **DEVICE)
    dp2.calc_uca()
    twi2 = dp2.calc_twi()
    assert dp2._dev("twi") is None
    np.testing.assert_array_almost_equal(np.nan_to_num(twi2),
                                         np.nan_to_num(twi), decimal=12)


@pytest.mark.parametrize("what", ["host backends", "drain_flats", "uca_init",
                                  "edge_done", "elev_fn", "save_array"])
def test_unported_paths_raise(what, tmp_path):
    """The paths that raised ``NotImplementedError`` while only the device
    chain was ported now run (their parity with the JAX package is held in
    ``tests/test_torch_api_host.py``); nothing of ``DEMProcessor`` is left
    that raises it.  ``ProcessManager`` takes ``mesh`` (a ``Mesh``; anything
    else is a ``TypeError``) and ``out_of_core``."""
    from pydem_tpu_torch.manager import ProcessManager
    from pydem_tpu_torch.parallel.mesh import make_mesh

    elev = _elev("fixture 13")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if what == "host backends":
            dp = DEMProcessor(elev=elev, device="cpu")
            assert np.isfinite(dp.calc_twi()).any() and dp._dev("uca") is None
        elif what == "drain_flats":
            uca = DEMProcessor(elev=elev, drain_pits=False, drain_flats=True,
                               **DEVICE).calc_uca()
            assert np.nanmax(uca) > 1
        elif what == "uca_init":
            dp = DEMProcessor(elev=elev, **DEVICE)
            uca0 = dp.calc_uca().copy()
            n, m = elev.shape
            sides = {"left": n, "right": n, "top": m, "bottom": m}
            data = {k: np.zeros(n) for k, n in sides.items()}
            flag = {k: np.zeros(n, bool) for k, n in sides.items()}
            out = dp.calc_uca(uca_init=uca0, edge_init_data=[data, flag, flag])
            np.testing.assert_array_equal(out, uca0)  # no edge data: no delta
        elif what == "edge_done":
            dp = DEMProcessor(elev=elev, **DEVICE)
            dp.calc_uca()
            assert dp.edge_done.shape == elev.shape
            assert dp.edge_done.dtype == bool
        elif what == "elev_fn":
            with pytest.raises(FileNotFoundError):
                DEMProcessor(str(tmp_path / "tile.tif"), device="cpu")
        else:
            dp = DEMProcessor(elev=elev, **DEVICE)
            dp.calc_uca()
            dp.save_array(str(tmp_path / "x"), "uca")
            dp2 = DEMProcessor(elev=elev, **DEVICE)
            dp2.load_uca(str(tmp_path / "x"))
            np.testing.assert_array_equal(dp2.uca, dp.uca)
    with pytest.raises(TypeError, match="Mesh"):
        ProcessManager(in_path=str(tmp_path), device="cpu", mesh=object())
    mesh = make_mesh(["cpu"] * 2, (1, 2))
    assert ProcessManager(in_path=str(tmp_path), device="cpu",
                          mesh=mesh).mesh is mesh
    pm = ProcessManager(in_path=str(tmp_path), device="cpu", out_of_core=True,
                        superblock=16)
    assert pm.out_of_core and pm.superblock == 16


def test_options_and_device_are_checked():
    elev = _elev("fixture 13")
    with pytest.raises(TypeError, match="Unknown DEMProcessor option"):
        DEMProcessor(elev=elev, device="cpu", no_such_option=1)
    dp = DEMProcessor(elev=elev, **DEVICE)
    assert dp.device == torch.device("cpu") and dp.dtype == torch.float64
    assert dp._resolved_solver() == "jacobi"  # "auto" on the CPU
    with pytest.raises(ValueError, match="uca_solver"):
        DEMProcessor(elev=elev, uca_solver="gauss", **DEVICE).calc_uca()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        DEMProcessor(elev=elev, device="cuda", **CHAIN)


@pytest.mark.parametrize("below_sea", [False, True])
def test_has_pits_matches_jax_beside_no_data(below_sea):
    """The pit gate treats a NaN neighbour as +inf (fmin), as the JAX gate
    does: a pit beside a no-data hole is still a pit."""
    elev = np.add.outer(np.arange(8.0), np.arange(8.0)) + 2
    elev[3, 3] = 0.5
    elev[3, 4] = np.nan
    elev[6, 1] = 0.0
    for e in (elev, np.where(np.isnan(elev), 5.0, elev)):
        want = bool(j_has_pits(e, below_sea=below_sea))
        got = bool(api._has_pits_program(torch.from_numpy(e),
                                         below_sea=below_sea))
        assert got == want
    # a ramp whose only low point is a sea pixel (0) has no pit
    assert not bool(api._has_pits_program(torch.from_numpy(
        np.add.outer(np.arange(8.0), np.arange(8.0)))))


def test_stage_probe_sees_every_stage():
    seen = []
    api._stage_probe = lambda name, val: seen.append(name)
    try:
        DEMProcessor(elev=_elev("fixture 13"), **DEVICE).calc_twi()
    finally:
        api._stage_probe = None
    assert seen[:2] == ["elev_upload", "fill_flats_device"]
    assert seen[-4:] == ["pit_links", "uca_solve", "twi_program",
                         "twi_download"]
    assert "pit_gate" in seen and "pre_program" in seen


@pytest.mark.parametrize("on_uca,limits", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_twi_program_matches_jax(on_uca, limits):
    """TWI with the reference's saturation options, as the JAX chain
    computes it on the device."""
    from pydem_tpu.api import _twi_program as j_twi

    rng = np.random.RandomState(6)
    uca = rng.uniform(1, 400, (16, 16))
    uca[3, 4] = np.nan
    mag = rng.uniform(0, 0.5, (16, 16))
    want = j_twi(uca, mag, 1.5, 1e-3, 32.0, on_uca, limits)
    got = api._twi_program(torch.from_numpy(uca), torch.from_numpy(mag),
                           torch.tensor(1.5, dtype=torch.float64), 1e-3, 32,
                           on_uca, limits)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_almost_equal(np.nan_to_num(got.numpy()),
                                         np.nan_to_num(np.asarray(want)),
                                         decimal=12)


def test_default_device_is_the_card():
    """Without ``device`` the processor runs on the GPU and raises without
    one; it never moves to the CPU by itself.  ``device="cpu"`` runs."""
    import inspect

    assert (inspect.signature(DEMProcessor.__init__).parameters["device"]
            .default == "cuda")
    elev = _elev("fixture 13")
    dp = DEMProcessor(elev=elev, **DEVICE)
    assert dp.device == torch.device("cpu")
    assert np.isfinite(dp.calc_twi()).any()
    if torch.cuda.is_available():
        assert DEMProcessor(elev=elev, **CHAIN).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DEMProcessor(elev=elev, **CHAIN)
        with pytest.raises(RuntimeError, match="cuda"):
            DEMProcessor(elev=elev)
