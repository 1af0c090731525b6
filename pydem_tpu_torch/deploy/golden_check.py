"""Golden regression of the port's image: the full pipeline on a fixed
input against the JAX package's goldens.

Counterpart of ``deploy/golden_check.py``, with its configuration
(fixture 33, a geodesically scaled cone, at 64², as 2×2 tiles with overlap
2, default options) through the port's ``ProcessManager``, and its goldens,
``deploy/goldens/*.tif``, read as data (the JAX package writes them; this
check never does, so it has no ``--write``):

- ``--device cpu`` (float64) must reproduce every exported GeoTIFF byte for
  byte;
- ``--device cuda`` (the default; float32 on the card) must reproduce them
  by value within the float32 envelope that ``tests/test_parity_f32.py``
  asserts for the JAX package: the elevation exact, every NaN mask equal,
  and the relative p99 over the pixels finite in both below
  :data:`F32_P99` (slope 1e-5, aspect 1e-4, uca 0.25, twi 0.06).  Every
  measured figure is printed.

Run: ``python -m pydem_tpu_torch.deploy.golden_check [--device cpu]``
(exit 1 on a mismatch).  The image's build runs it with ``--device cpu``:
a build has no card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import warnings

import numpy as np

KEYS = ("elev", "aspect", "slope", "uca", "twi")
# the goldens of the checkout this package sits in
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "deploy", "goldens")
# relative p99 limits on the card (tests/test_parity_f32.py's envelope)
F32_P99 = {"slope": 1e-5, "aspect": 1e-4, "uca": 0.25, "twi": 0.06}
NODATA = -9999.0  # the export's no-data value


def run_pipeline(workdir, device):
    """The fixed tiles -> the full pipeline on ``device`` -> the exported
    GeoTIFF directory."""
    from .. import fixtures
    from ..manager import ProcessManager

    tiles = fixtures.mk_test_multifile(33, 64, workdir, nx_grid=2, ny_grid=2,
                                       nx_overlap=2, ny_overlap=2)
    out = os.path.join(workdir, "results_geotiff")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = ProcessManager(in_path=tiles,
                            out_path=os.path.join(workdir, "results.zarr"),
                            device=device)
        pm.process_twi()
        pm.save_non_overlap_data_geotiff(out)
    return out


def envelope(got, exp):
    """NaN masks equal (no-data read as NaN), and over the pixels finite in
    both: the relative p99 and max, as ``tests/test_parity_f32.py``
    measures them."""
    got = np.where(got == NODATA, np.nan, got).astype("float64")
    exp = np.where(exp == NODATA, np.nan, exp).astype("float64")
    ok = np.isfinite(got) & np.isfinite(exp)
    rel = np.abs(got[ok] - exp[ok]) / np.maximum(np.abs(exp[ok]), 1e-30)
    return {"nan_match": bool(np.array_equal(np.isnan(got), np.isnan(exp))),
            "p99": float(np.quantile(rel, 0.99)) if rel.size else 0.0,
            "max": float(rel.max()) if rel.size else 0.0}


def compare(out, device):
    """Each exported file against its golden; returns (failed keys,
    {key: figures})."""
    from ..io import read_geotiff

    exact = _is_cpu(device)
    failed, figures = [], {}
    for key in KEYS:
        got_fn = os.path.join(out, key + ".tif")
        exp_fn = os.path.join(GOLDEN_DIR, key + ".tif")
        with open(got_fn, "rb") as f:
            got_bytes = f.read()
        with open(exp_fn, "rb") as f:
            exp_bytes = f.read()
        same = got_bytes == exp_bytes
        got, exp = read_geotiff(got_fn).data, read_geotiff(exp_fn).data
        fig = dict(envelope(got, exp), bitwise=same,
                   values_equal=bool(np.array_equal(got, exp)))
        figures[key] = fig
        if exact:
            ok = same
            how = "bitwise" if same else "%d px differ%s" % (
                int((got != exp).sum()),
                "" if not fig["values_equal"] else " (values equal, "
                "container bytes differ)")
        elif key == "elev":
            ok = fig["values_equal"]
            how = "values %s" % ("equal" if ok else "differ")
        else:
            ok = fig["nan_match"] and fig["p99"] < F32_P99[key]
            how = "NaN masks %s, rel p99 %.3e (limit %g), max %.3e" % (
                "equal" if fig["nan_match"] else "DIFFER", fig["p99"],
                F32_P99[key], fig["max"])
        print("%s  %-6s %s" % ("OK      " if ok else "MISMATCH", key, how),
              flush=True)
        if not ok:
            failed.append(key)
    return failed, figures


def _is_cpu(device):
    import torch

    return torch.device(device).type == "cpu"


def check(device="cuda"):
    """Run the pipeline on ``device`` in a temporary directory and compare
    its exports; returns (failed keys, {key: figures})."""
    work = tempfile.mkdtemp(prefix="pydem_torch_golden_")
    try:
        return compare(run_pipeline(work, device), device)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="golden regression of the "
                                             "port's pipeline")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, float32, checked "
                         "within the float32 envelope; cpu: float64, "
                         "checked byte for byte)")
    args = ap.parse_args(argv)

    failed, _figures = check(args.device)
    if failed:
        print("GOLDEN CHECK FAILED on %s: %s" % (args.device,
                                                 ", ".join(failed)))
        return 1
    print("golden check passed on %s (%s)" % (
        args.device, "byte for byte" if _is_cpu(args.device)
        else "within the float32 envelope"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
