"""The facet sweep's dispatch on the CPU: a CPU grid takes the eager sweep
and never the kernel (``ops.facets``), whose wrapper rejects what the
kernel cannot run before it builds or loads anything.  The kernel itself is
checked against the eager sweep on the card (``tests/test_torch_cuda.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pydem_tpu_torch.core import slope_direction as sd
from pydem_tpu_torch.ops import _build, facets
from pydem_tpu_torch.profiling import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_build(*_args, **_kwargs):
    raise AssertionError("the CPU path built or loaded a CUDA library")


@pytest.fixture
def no_cuda_library(monkeypatch):
    """Fail on any attempt to build, load or call a CUDA library, whether
    or not an earlier test in this process loaded one."""
    monkeypatch.setattr(_build, "build", _no_build)
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(facets, "_entry", _no_build)


def _elev(n, m, dtype, seed=3):
    rng = np.random.RandomState(seed)
    z = np.round(rng.rand(n, m) * 4)  # ties
    z[n // 2:, : m // 2] = np.nan
    return torch.tensor(z, dtype=dtype)


@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (5, 2), (3, 3), (17, 23)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_takes_the_eager_sweep(no_cuda_library, shape, dtype):
    n, m = shape
    elev = _elev(n, m, dtype)
    dX = torch.linspace(20.0, 30.0, n - 1, dtype=dtype)
    before = counters["facet_kernel"]
    mag, direction = sd.slopes_directions(elev, dX, 25.0)
    want_mag, want_dir = sd._slopes_directions_eager(elev, dX, 25.0)
    assert counters["facet_kernel"] == before
    assert torch.equal(mag.view(torch.uint8), want_mag.view(torch.uint8))
    assert torch.equal(direction.view(torch.uint8),
                       want_dir.view(torch.uint8))


@pytest.mark.parametrize("elev,error", [
    (torch.zeros(4, 4), ValueError),                       # on the CPU
    (torch.zeros(4, 4, dtype=torch.float16), TypeError),
    (torch.zeros(4, 4, dtype=torch.int32), TypeError),
    (torch.zeros(1, 5), ValueError),
    (torch.zeros(5, 1), ValueError),
    (torch.zeros(5), ValueError),
    (torch.zeros(2, 3, 3), ValueError),
])
def test_wrapper_rejects_what_the_kernel_cannot_run(no_cuda_library, elev,
                                                    error):
    n = elev.shape[0]
    d = torch.ones(max(n - 1, 1), dtype=elev.dtype)
    before = counters["facet_kernel"]
    with pytest.raises(error):
        facets.facet_sweep(elev, d, d)
    assert counters["facet_kernel"] == before


def test_imports_need_no_cuda_library():
    """A fresh interpreter imports the sweep, its wrapper and the terrain
    step, and runs the sweep on the CPU, with no way to build or load a
    CUDA library."""
    code = (
        "from pydem_tpu_torch.ops import _build\n"
        "_build.build = _build.load = None\n"
        "import torch\n"
        "from pydem_tpu_torch.core.slope_direction import slopes_directions\n"
        "from pydem_tpu_torch.ops import facets\n"
        "from pydem_tpu_torch.parallel import sharded\n"
        "mag, _ = slopes_directions(torch.rand(6, 7), 1.0, 1.0)\n"
        "assert mag.shape == (6, 7)\n")
    env = dict(os.environ, CUDA_HOME=os.devnull, PATH=os.defpath,
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
