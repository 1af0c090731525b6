"""The flat-region label flood on the card: ``csrc/flood.cu``.

:func:`flood_labels` computes the labels of
:func:`~pydem_tpu_torch.core.slope_direction.label_flood` (each mask pixel
the smallest flat index of its 8-connected component, ``n * m`` off the
mask), bit for bit, by a block-based union-find in three launches and no
host read; :func:`~pydem_tpu_torch.core.slope_direction.label_flood` takes
it for every CUDA mask, and its eager loop (``_label_flood_eager``) for a
CPU one.  Each call adds one to the ``flood_kernel`` counter of
:mod:`pydem_tpu_torch.profiling`, and the number of kernels the C entry
reports it launched to ``flood_launches``.  Nothing here builds or loads
the library until the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..profiling import count


def flood_labels(mask):
    """The int32 ``(n, m)`` label plane of the bool ``(n, m)`` ``mask`` on
    its CUDA device, ``n * m < 2^31``.  Raises on anything else, and if a
    launch fails."""
    if mask.dim() != 2:
        raise ValueError("flood_labels: mask must be (n, m), got %s"
                         % (tuple(mask.shape),))
    if mask.dtype != torch.bool:
        raise TypeError("flood_labels: mask must be bool, got %s"
                        % mask.dtype)
    n, m = mask.shape
    # int32 labels: n * m itself marks the pixels off the mask
    if n * m >= 2 ** 31:
        raise ValueError("flood_labels: canvas has %d pixels >= 2^31; "
                         "int32 labels would overflow" % (n * m))
    if mask.device.type != "cuda":
        raise ValueError("flood_labels: mask is on %s, not a CUDA device"
                         % mask.device)
    mask = mask.contiguous()
    lbl = torch.empty((n, m), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        launched = _entry()(mask.data_ptr(), lbl.data_ptr(), n, m, stream)
    if launched < 0:
        raise RuntimeError("flood_labels launch failed: cudaError %d"
                           % -launched)
    count("flood_kernel")
    count("flood_launches", launched)
    return lbl


@functools.cache
def _entry():
    from ._build import load

    fn = load("flood").flood_labels
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
