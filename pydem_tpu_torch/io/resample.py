"""Overview resampling methods (reference parity: the reference accepts any
rasterio ``Resampling.<type>`` for its overview pyramids,
``process_manager.py:853-858, 964-966``).

Implemented host-side (overviews are export-path IO, not the compute path):

- ``mean`` / ``average`` — NaN-ignoring block mean (GDAL ``average``)
- ``nearest``            — upper-left sample of each block
- ``bilinear``           — 2-tap separable interpolation at mapped centers
- ``cubic``              — 4-tap Keys bicubic (a = -0.5) at mapped centers

For the interpolating methods each coarse pixel (r, c) samples the fine
grid at ``((r + 0.5)·f − 0.5, (c + 0.5)·f − 0.5)`` (the GDAL center
mapping); edges clamp (replicate).  Note that for ODD factors — including
the reference's default 3^k pyramid — the mapped centers are exact fine
pixels, so bilinear and cubic degenerate to the central sample by
construction.  NaN (no-data) propagates through the interpolating kernels;
``mean`` ignores it.

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/io/resample.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import numpy as np

METHODS = ("mean", "average", "nearest", "bilinear", "cubic")


def _axis_taps(coarse_lo, coarse_hi, fac, method, src_len):
    """(indices (k, taps), weights (k, taps)) sampling positions along one
    axis for coarse pixels [coarse_lo, coarse_hi), clamped to the source."""
    y = (np.arange(coarse_lo, coarse_hi) + 0.5) * fac - 0.5
    y0 = np.floor(y).astype(np.int64)
    t = y - y0
    if method == "bilinear":
        offs = np.array([0, 1])
        w = np.stack([1 - t, t], axis=1)
    else:  # cubic, Keys a = -0.5
        a = -0.5
        offs = np.array([-1, 0, 1, 2])
        s = np.abs(t[:, None] - offs[None, :])
        w = np.where(
            s <= 1, (a + 2) * s ** 3 - (a + 3) * s ** 2 + 1,
            np.where(s < 2,
                     a * s ** 3 - 5 * a * s ** 2 + 8 * a * s - 4 * a, 0.0))
    idx = np.clip(y0[:, None] + offs[None, :], 0, src_len - 1)
    return idx, w


def _interp_axis(data, idx, w, axis):
    out = np.zeros_like(np.take(data, idx[:, 0], axis=axis), dtype="float64")
    for k in range(idx.shape[1]):
        tap = np.take(data, idx[:, k], axis=axis).astype("float64")
        wk = w[:, k]
        shape = [1] * tap.ndim
        shape[axis] = -1
        out += tap * wk.reshape(shape)
    return out


def downsample(data, fac, method="mean"):
    """Downsample a 2-D array by integer factor ``fac``."""
    n, m = data.shape
    n2, m2 = n // fac, m // fac
    if method in ("mean", "average"):
        trimmed = data[: n2 * fac, : m2 * fac]
        with np.errstate(invalid="ignore"):
            return np.nanmean(trimmed.reshape(n2, fac, m2, fac),
                              axis=(1, 3))
    if method == "nearest":
        return data[: n2 * fac: fac, : m2 * fac: fac].copy()
    if method in ("bilinear", "cubic"):
        ri, rw = _axis_taps(0, n2, fac, method, n)
        ci, cw = _axis_taps(0, m2, fac, method, m)
        out = _interp_axis(data, ri, rw, axis=0)
        return _interp_axis(out, ci, cw, axis=1)
    raise ValueError("unknown resampling method %r (supported: %s)"
                     % (method, ", ".join(METHODS)))


def downsample_rows(read_window, fac, method, row0, row1, n_src, m_src):
    """Coarse rows [row0, row1) over the full coarse width, streamed: reads
    only the fine rows the method needs (plus the kernel margin for the
    interpolating methods) via ``read_window((r0, r1), (c0, c1))``."""
    m2 = m_src // fac
    if method in ("mean", "average", "nearest"):
        band = read_window((row0 * fac, row1 * fac), (0, m2 * fac))
        if method == "nearest":
            return band[::fac, ::fac].copy()
        with np.errstate(invalid="ignore"):
            return np.nanmean(
                band.reshape(row1 - row0, fac, m2, fac), axis=(1, 3))
    if method not in ("bilinear", "cubic"):
        raise ValueError("unknown resampling method %r (supported: %s)"
                         % (method, ", ".join(METHODS)))
    ri, rw = _axis_taps(row0, row1, fac, method, n_src)
    lo = int(ri.min())
    hi = int(ri.max()) + 1
    band = read_window((lo, hi), (0, m_src))
    ci, cw = _axis_taps(0, m2, fac, method, m_src)
    out = _interp_axis(band, ri - lo, rw, axis=0)
    return _interp_axis(out, ci, cw, axis=1)
