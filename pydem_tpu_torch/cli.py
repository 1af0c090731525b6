"""Command-line tools: TWIDinf, AreaDinf, DinfFlowDir, process.

Port of ``pydem_tpu/cli.py`` (working replacements for the reference pyDEM's
console scripts, ``commandline_utils.py:18-149``), with the same positional
conventions:

    DinfFlowDir  <elevation.tif> [output_prefix]       -> mag + angle
    AreaDinf     <elevation.tif> [output_prefix]       -> uca
    TWIDinf      <elevation.tif> [output_prefix]       -> twi (and uca, slope)

plus ``process <directory>`` for the multi-tile pipeline
(ProcessManager.process_twi + GeoTIFF export).  Run as
``python -m pydem_tpu_torch.cli <command> ...`` or through the console
scripts ``DinfFlowDir-torch``, ``AreaDinf-torch``, ``TWIDinf-torch`` and
``pydem-torch-process``.  Every command takes ``--device`` (default
``cuda``): without a GPU it fails unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load(elev_fn, args):
    from .api import DEMProcessor

    kwargs = {}
    if args.no_fill_flats:
        kwargs["fill_flats"] = False
        kwargs["drain_pits_path"] = False
    return DEMProcessor(elev_fn=elev_fn, device=args.device, **kwargs)


def _save(fn, data, dp, dtype="float32"):
    from .io.geotiff import write_geotiff

    transform = tuple(dp.transform) if dp.transform else \
        (1.0, 0.0, 0.0, 0.0, -1.0, 0.0)
    write_geotiff(fn, np.asarray(data, dtype), transform, nodata=-9999,
                  compress=True)
    print("wrote", fn)


def _base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("elevation", help="input elevation GeoTIFF")
    p.add_argument("output", nargs="?", default=None,
                   help="output prefix (default: input path sans extension)")
    p.add_argument("--no-fill-flats", action="store_true",
                   help="skip elevation conditioning")
    _add_device(p)
    return p


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda; the CPU "
                        "only when asked for with --device cpu)")


def _prefix(args):
    return args.output or os.path.splitext(args.elevation)[0]


def dinf_flow_dir(argv=None):
    args = _base_parser("D-infinity slope magnitude and flow direction "
                        "(Tarboton)").parse_args(argv)
    dp = _load(args.elevation, args)
    mag, ang = dp.calc_slopes_directions()
    _save(_prefix(args) + "_mag.tif", mag, dp)
    _save(_prefix(args) + "_ang.tif", ang, dp)


def area_dinf(argv=None):
    args = _base_parser("D-infinity upstream contributing area").parse_args(argv)
    dp = _load(args.elevation, args)
    uca = dp.calc_uca()
    _save(_prefix(args) + "_uca.tif", uca, dp)


def twi_dinf(argv=None):
    args = _base_parser("Topographic wetness index "
                        "(slope, UCA, and TWI)").parse_args(argv)
    dp = _load(args.elevation, args)
    dp.calc_twi()
    _save(_prefix(args) + "_slope.tif", dp.mag, dp)
    _save(_prefix(args) + "_ang.tif", dp.direction, dp)
    _save(_prefix(args) + "_uca.tif", dp.uca, dp)
    _save(_prefix(args) + "_twi.tif", dp.twi, dp)


def process(argv=None):
    p = argparse.ArgumentParser(
        description="Process a directory of elevation tiles end-to-end "
                    "(mosaic, condition, slope, UCA, TWI, export)")
    p.add_argument("directory", help="directory of input GeoTIFF tiles")
    p.add_argument("--out", default=None, help="output directory for GeoTIFFs")
    p.add_argument("--store", default=None,
                   help="intermediate store path (default "
                        "<directory>/results.zarr)")
    p.add_argument("--resume", action="store_true",
                   help="skip stages whose outputs already exist in the "
                        "store (crash/preemption recovery)")
    p.add_argument("--out-of-core", action="store_true",
                   help="bounded-memory mode: stream super-blocks through "
                        "the store instead of holding one canvas")
    p.add_argument("--superblock", type=int, default=4096,
                   help="out-of-core super-block size (pixels)")
    p.add_argument("--resampling", default="mean",
                   choices=("mean", "average", "nearest", "bilinear",
                            "cubic"),
                   help="overview-pyramid resampling method")
    _add_device(p)
    args = p.parse_args(argv)
    from .manager import ProcessManager

    pm = ProcessManager(in_path=args.directory, out_path=args.store,
                        resume=args.resume, out_of_core=args.out_of_core,
                        superblock=args.superblock, device=args.device)
    pm.process_twi()
    written = pm.save_non_overlap_data_geotiff(args.out,
                                               resampling=args.resampling)
    for fn in written:
        print("wrote", fn)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"TWIDinf": twi_dinf, "AreaDinf": area_dinf,
            "DinfFlowDir": dinf_flow_dir, "process": process}
    if not argv or argv[0] not in cmds:
        print("usage: python -m pydem_tpu_torch.cli {TWIDinf|AreaDinf|"
              "DinfFlowDir|process} ...", file=sys.stderr)
        return 2
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
