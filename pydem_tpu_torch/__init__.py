"""pydem_tpu_torch — the terrain-hydrology stencil engine on PyTorch and CUDA.

A port of :mod:`pydem_tpu` (JAX/XLA/Pallas) that keeps its module paths and
function names.  Plain tensor code is PyTorch; the Pallas UCA block kernel is
a CUDA C++ kernel for Hopper (``ops/csrc/uca_block.cu``), built with ``nvcc``
on first use.  The package imports neither ``jax`` nor ``pydem_tpu``.

Dtype/device policy: functions take the device from their input tensors.
Callers run float64 on the CPU (for parity with the JAX package, which runs
x64 on the CPU) and float32 on CUDA (as the JAX package runs float32 on the
chip); :func:`default_dtype` names that choice.

The package root has the JAX package's surface: ``DEMProcessor``,
``fixtures``, ``geometry``, ``utils`` and the reference's aliases
``process_manager`` (:mod:`.manager`) and ``utils_test_pydem``
(:mod:`.fixtures`).  They resolve on first access (PEP 562), so importing
the package loads no submodule, and not even ``torch``: a worker of
:mod:`.deploy.worker` times its own ``import torch``.
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

# name at the package root -> (submodule, attribute or None for the module)
_LAZY = {"DEMProcessor": ("api", "DEMProcessor"),
         "fixtures": ("fixtures", None),
         "geometry": ("geometry", None),
         "utils": ("utils", None),
         "process_manager": ("manager", None),
         "utils_test_pydem": ("fixtures", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    module, attr = _LAZY[name]
    mod = importlib.import_module("." + module, __name__)
    return mod if attr is None else getattr(mod, attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


def default_dtype(device):
    """float64 on the CPU, float32 on an accelerator."""
    import torch

    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
