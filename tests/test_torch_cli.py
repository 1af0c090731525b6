"""pydem_tpu_torch.cli on the CPU: the four commands with ``--device cpu``
against the JAX package's CLI on the same file (written GeoTIFFs equal to
``decimal=5``, they are float32; the NaN/no-data pattern exact), the refusal
to run without ``--device cpu`` on a machine without a GPU, and
``process --out-of-core`` against the in-memory route.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from pydem_tpu import cli as j_cli
from pydem_tpu_torch import cli, fixtures, manager
from pydem_tpu_torch.geometry import mk_transform
from pydem_tpu_torch.io import read_geotiff, write_geotiff

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _mk_tile(tmp_path, n=16):
    elev, _ang, _uca = fixtures.get_test_case(33, n)
    fn = str(tmp_path / "elev.tif")
    write_geotiff(fn, np.asarray(elev, "float64"),
                  mk_transform(1.0, -1.0, 2.0 / n, 2.0 / n))
    return fn


def _same_tif(got_fn, want_fn):
    got, want = read_geotiff(got_fn), read_geotiff(want_fn)
    assert got.data.dtype == want.data.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got.data), np.isnan(want.data))
    np.testing.assert_array_almost_equal(np.nan_to_num(got.data),
                                         np.nan_to_num(want.data), decimal=5)
    assert tuple(got.transform) == tuple(want.transform)
    assert got.nodata == want.nodata == -9999


@pytest.mark.parametrize("cmd,suffixes", [
    ("TWIDinf", ("_slope", "_ang", "_uca", "_twi")),
    ("AreaDinf", ("_uca",)),
    ("DinfFlowDir", ("_mag", "_ang")),
])
def test_single_tile_commands_match_jax(tmp_path, cmd, suffixes):
    fn = _mk_tile(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main([cmd, fn, str(tmp_path / "t"), "--device", "cpu"])
        j_cli.main([cmd, fn, str(tmp_path / "j")])
    for suffix in suffixes:
        _same_tif(str(tmp_path / ("t%s.tif" % suffix)),
                  str(tmp_path / ("j%s.tif" % suffix)))
    if cmd == "AreaDinf":
        assert np.nanmax(read_geotiff(str(tmp_path / "t_uca.tif")).data) > 1


def test_no_fill_flats_and_default_prefix(tmp_path):
    fn = _mk_tile(tmp_path)
    cli.dinf_flow_dir([fn, "--no-fill-flats", "--device", "cpu"])
    g = read_geotiff(str(tmp_path / "elev_ang.tif"))
    finite = g.data[np.isfinite(g.data) & (g.data >= 0)]
    assert finite.size and finite.max() <= 2 * np.pi + 1e-6


def test_unknown_command(capsys):
    assert cli.main(["NoSuchCmd"]) == 2
    assert "pydem_tpu_torch.cli" in capsys.readouterr().err
    assert cli.main([]) == 2


@pytest.fixture
def tiles(tmp_path):
    manager.DEBUG = True
    yield fixtures.mk_test_multifile(33, 32, str(tmp_path), nx_grid=2,
                                     ny_grid=2, nx_overlap=2, ny_overlap=2)
    manager.DEBUG = False


def test_process_command(tiles, tmp_path):
    """``process``: the five GeoTIFFs, ``--store``, ``--resampling``, and a
    ``--resume`` rerun that gives the same files."""
    out = str(tmp_path / "out")
    store = str(tmp_path / "store.zarr")
    args = [tiles, "--out", out, "--store", store, "--resampling",
            "bilinear", "--device", "cpu"]
    assert cli.main(["process"] + args) in (0, None)
    names = sorted(os.listdir(out))
    assert names == ["aspect.tif", "elev.tif", "slope.tif", "twi.tif",
                     "uca.tif"]
    assert os.path.exists(os.path.join(store, "metrics.json"))
    first = {n: open(os.path.join(out, n), "rb").read() for n in names}
    assert cli.process(args + ["--resume"]) in (0, None)
    for n in names:
        assert open(os.path.join(out, n), "rb").read() == first[n]
    assert read_geotiff(os.path.join(out, "twi.tif"), ifd_index=1).shape == \
        (32 // 3, 32 // 3)


def test_process_out_of_core(tiles, tmp_path):
    """``process --out-of-core --superblock 16 --resume`` twice (the case of
    the JAX package's ``tests/test_cli.py``): the second run resumes from the
    store and writes the same files; the files equal the in-memory route's
    (float32, ``decimal=5``)."""
    out = str(tmp_path / "out")
    store = str(tmp_path / "ooc.zarr")
    args = [tiles, "--out", out, "--store", store, "--out-of-core",
            "--superblock", "16", "--resume", "--device", "cpu"]
    assert cli.main(["process"] + args) in (0, None)
    names = sorted(os.listdir(out))
    assert names == ["aspect.tif", "elev.tif", "slope.tif", "twi.tif",
                     "uca.tif"]
    for flag in ("_oocore_uca.json", "_oocore_condition.json",
                 "pit_links.npz", "metrics.json"):
        assert os.path.exists(os.path.join(store, flag)), flag
    first = {n: open(os.path.join(out, n), "rb").read() for n in names}
    assert cli.main(["process"] + args) in (0, None)
    for n in names:
        assert open(os.path.join(out, n), "rb").read() == first[n]
    mem = str(tmp_path / "mem")
    cli.process([tiles, "--out", mem, "--store", str(tmp_path / "mem.zarr"),
                 "--device", "cpu"])
    for n in names:
        _same_tif(os.path.join(out, n), os.path.join(mem, n))


@pytest.mark.parametrize("cmd", ["TWIDinf", "AreaDinf", "DinfFlowDir",
                                 "process"])
def test_commands_refuse_to_run_without_a_gpu(tmp_path, tiles, cmd):
    """The default device is ``cuda``: without a GPU and without
    ``--device cpu`` every command fails with the RuntimeError about CUDA and
    writes nothing; it never runs on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    target = tiles if cmd == "process" else _mk_tile(tmp_path)
    before = sorted(os.listdir(str(tmp_path)))
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        cli.main([cmd, target])
    assert sorted(os.listdir(str(tmp_path))) == before
    assert not os.path.exists(os.path.join(tiles, "results_geotiff"))


def test_module_entry_point_as_a_subprocess(tmp_path):
    """``python -m pydem_tpu_torch.cli``: exit code 0 with ``--device cpu``,
    non-zero with the CUDA RuntimeError without it (no GPU here), 2 on an
    unknown command."""
    fn = _mk_tile(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "pydem_tpu_torch.cli", *args], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=600)

    r = run("AreaDinf", fn, str(tmp_path / "sub"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "wrote" in r.stdout
    assert os.path.exists(str(tmp_path / "sub_uca.tif"))
    assert run("NoSuchCmd").returncode == 2
    if not torch.cuda.is_available():
        r = run("AreaDinf", fn, str(tmp_path / "sub2"))
        assert r.returncode != 0
        assert "RuntimeError" in r.stderr and "cuda" in r.stderr
        assert not os.path.exists(str(tmp_path / "sub2_uca.tif"))


def test_console_scripts_are_registered():
    """pyproject.toml names the port's four scripts beside the JAX
    package's, each pointing at a function of the port's cli."""
    import re

    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    scripts = dict(re.findall(r'^([\w-]+) = "(pydem_tpu\w*\.cli:\w+)"$', text,
                              re.M))
    for name, target in (("TWIDinf-torch", "twi_dinf"),
                         ("AreaDinf-torch", "area_dinf"),
                         ("DinfFlowDir-torch", "dinf_flow_dir"),
                         ("pydem-torch-process", "process")):
        assert scripts[name] == "pydem_tpu_torch.cli:" + target
        assert callable(getattr(cli, target))
    for name in ("TWIDinf", "AreaDinf", "DinfFlowDir", "pydem-tpu-process"):
        assert scripts[name].startswith("pydem_tpu.cli:")
