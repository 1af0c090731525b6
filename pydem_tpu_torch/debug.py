"""Debug visualization escape hatch (matplotlib-gated).

Counterpart of the reference's ``_plot_connectivity`` / debug plots
(dem_processing.py:1679-1709, process_manager.py:1143-1203): renders the
drainage connectivity (receiver weights as arrows over the elevation) and
field heatmaps.  Imported lazily; requires matplotlib only when called.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/debug.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import numpy as np

from .core.stencil import NEIGHBOR_OFFSETS


def plot_connectivity(W, elev, ax=None, lims=(None, None)):
    """Quiver the receiver-weight planes over the elevation raster."""
    from matplotlib import pyplot

    W = np.asarray(W)
    elev = np.asarray(elev)
    n, m = elev.shape
    if ax is None:
        _fig, ax = pyplot.subplots()
    im = ax.matshow(elev, cmap="gist_rainbow")
    im.set_clim(*lims)
    ii, jj = np.mgrid[0:n, 0:m]
    for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
        w = W[k]
        sel = w > 0
        if not sel.any():
            continue
        ax.quiver(jj[sel], ii[sel], np.full(sel.sum(), dj),
                  np.full(sel.sum(), di), w[sel], angles="xy",
                  scale_units="xy", scale=1.5, cmap="bone", clim=(0, 1))
    return ax


def plot_fields(processor, keys=("elev", "mag", "direction", "uca", "twi")):
    """Grid of heatmaps of DEMProcessor state fields."""
    from matplotlib import pyplot

    avail = [k for k in keys if getattr(processor, k, None) is not None]
    fig, axes = pyplot.subplots(1, len(avail), figsize=(4 * len(avail), 4))
    if len(avail) == 1:
        axes = [axes]
    for ax, key in zip(axes, avail):
        im = ax.imshow(np.asarray(getattr(processor, key), "float64"))
        ax.set_title(key)
        fig.colorbar(im, ax=ax, shrink=0.7)
    return fig
