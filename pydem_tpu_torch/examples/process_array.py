"""Process an in-memory elevation array end to end.

Twin of ``examples/process_array.py`` on the port: build a DEMProcessor from
a numpy array, run slope/aspect -> UCA -> TWI, and save the UCA.

Run:  python -m pydem_tpu_torch.examples.process_array [--device cpu]
(on the GPU unless ``--device cpu`` is given; without a GPU the default
raises)
"""
import argparse
import os
import tempfile

import numpy as np

from pydem_tpu_torch import DEMProcessor


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the "
                         "CPU)")
    args = ap.parse_args(argv)

    # a synthetic cone with quantization flats; swap in your own DEM array
    n = 256
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = np.round((1 - np.sqrt(x**2 + y**2)) * 50) / 50 + 0.05

    # dX/dY: pixel sizes in meters (scalars or per-row arrays).  Constructing
    # from a GeoTIFF instead (DEMProcessor(elev_fn="tile.tif")) derives
    # per-row geodesic sizes from the raster CRS automatically.
    dp = DEMProcessor(elev=elev, dX=30.0, dY=30.0, device=args.device)

    mag, aspect = dp.calc_slopes_directions()
    uca = dp.calc_uca()
    twi = dp.calc_twi()

    print("slope    min/max: %.4f / %.4f" % (np.nanmin(mag), np.nanmax(mag)))
    print("uca      min/max: %.1f / %.1f" % (np.nanmin(uca), np.nanmax(uca)))
    print("twi      min/max: %.2f / %.2f" % (np.nanmin(twi), np.nanmax(twi)))

    # persistence (the reference's save_array conventions)
    with tempfile.TemporaryDirectory() as work:
        dp.save_array(os.path.join(work, "example_uca"), "uca")
        print("saved example_uca.npz")
    return {"slope": mag, "aspect": aspect, "uca": uca, "twi": twi}


if __name__ == "__main__":
    main()
