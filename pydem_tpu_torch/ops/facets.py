"""The D∞ facet sweep on the card: ``csrc/facets.cu``.

:func:`facet_sweep` computes what
:func:`~pydem_tpu_torch.core.slope_direction.slopes_directions` returns,
bit for bit, in two launches (the pixels, then the frame's ordered edge
copies); :func:`~pydem_tpu_torch.core.slope_direction.slopes_directions`
takes it for a CUDA tensor of a type in :data:`DTYPES` with at least two
rows and two columns, and its eager PyTorch version
(``_slopes_directions_eager``) for everything else.  Each call adds one
to the ``facet_kernel`` counter of :mod:`pydem_tpu_torch.profiling`, and
the number of kernels the C entry reports it launched to ``facet_launches``.
Nothing here builds or loads the library until the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..profiling import count

# the element types the kernel is built for, by C entry
DTYPES = {torch.float32: "facet_sweep_f32", torch.float64: "facet_sweep_f64"}


def facet_sweep(elev, dX, dY):
    """``(mag, direction)`` of the facet sweep of ``elev`` on its CUDA
    device.

    ``elev``: (n, m) with n, m >= 2, float32 or float64, contiguous.
    ``dX``, ``dY``: (n - 1,) row spacings of the same type and device,
    contiguous.  Raises on anything else, and if the launch fails.
    """
    if elev.dim() != 2 or elev.shape[0] < 2 or elev.shape[1] < 2:
        raise ValueError("facet_sweep: elev must be (n, m) with n, m >= 2, "
                         "got %s" % (tuple(elev.shape),))
    if elev.dtype not in DTYPES:
        raise TypeError("facet_sweep: the kernel takes %s, got %s"
                        % (sorted(map(str, DTYPES)), elev.dtype))
    if elev.device.type != "cuda":
        raise ValueError("facet_sweep: elev is on %s, not a CUDA device"
                         % elev.device)
    n, m = elev.shape
    for name, t in (("elev", elev), ("dX", dX), ("dY", dY)):
        if t.dtype != elev.dtype or t.device != elev.device:
            raise ValueError("facet_sweep: %s is %s on %s, elev %s on %s"
                             % (name, t.dtype, t.device, elev.dtype,
                                elev.device))
        if not t.is_contiguous():
            raise ValueError("facet_sweep: %s must be contiguous" % name)
    for name, t in (("dX", dX), ("dY", dY)):
        if tuple(t.shape) != (n - 1,):
            raise ValueError("facet_sweep: %s must be (%d,), got %s"
                             % (name, n - 1, tuple(t.shape)))
    mag = torch.empty_like(elev)
    direction = torch.empty_like(elev)
    side = torch.empty(2 * (2 * n + 2 * m - 4), dtype=elev.dtype,
                       device=elev.device)
    with torch.cuda.device(elev.device):
        stream = torch.cuda.current_stream(elev.device).cuda_stream
        launched = _entry(DTYPES[elev.dtype])(
            elev.data_ptr(), dX.data_ptr(), dY.data_ptr(), mag.data_ptr(),
            direction.data_ptr(), side.data_ptr(), n, m, stream)
    if launched < 0:
        raise RuntimeError("facet_sweep launch failed: cudaError %d"
                           % -launched)
    count("facet_kernel")
    count("facet_launches", launched)
    return mag, direction


@functools.cache
def _entry(name):
    from ._build import load

    fn = getattr(load("facets"), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
