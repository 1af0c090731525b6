"""Process a directory of elevation tiles with ProcessManager.

Twin of ``examples/process_manager_directory.py`` on the port: discover the
tile grid, run the full pipeline, export de-overlapped GeoTIFFs with
overview pyramids.

Run:  python -m pydem_tpu_torch.examples.process_manager_directory
      [tile_dir] [--device cpu]
(without a directory, a demo tile directory is generated first; on the GPU
unless ``--device cpu`` is given, and without a GPU the default raises)
"""
import argparse
import os
import tempfile

from pydem_tpu_torch import fixtures
from pydem_tpu_torch.manager import ProcessManager


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tile_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the "
                         "CPU)")
    args = ap.parse_args(argv)

    tile_dir = args.tile_dir
    if tile_dir is None:
        work = tempfile.mkdtemp(prefix="pydem_torch_demo_")
        tile_dir = fixtures.mk_test_multifile(33, 64, work, nx_grid=2,
                                              ny_grid=2, nx_overlap=2,
                                              ny_overlap=2)
        print("generated demo tiles in", tile_dir)

    pm = ProcessManager(
        in_path=tile_dir,
        # resume=True skips stages already present in the store (crash
        # recovery)
        resume=False,
        # out_of_core=True streams S x S super-blocks for domains larger
        # than memory; mesh=... shards the canvas over the cards
        device=args.device,
    )
    pm.process_twi()
    written = pm.save_non_overlap_data_geotiff(
        os.path.join(tile_dir, "..", "results_geotiff"))
    print("exported:")
    for fn in written:
        print(" ", fn)
    print("metrics:", os.path.join(pm.out_path, "metrics.json"))
    return pm, written


if __name__ == "__main__":
    main()
