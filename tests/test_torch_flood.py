"""The label flood on the CPU: a CPU mask takes the eager loop and never the
union-find kernel (``ops.flood``), whose wrapper rejects what the kernel
cannot run before it builds or loads anything; the eager loop's labels are
the smallest flat index of each 8-connected component that
``scipy.ndimage.label`` finds, and ``rep`` the payload there.  The kernel
itself is checked against the eager loop on the card
(``tests/test_torch_cuda.py``, on the masks of :func:`flood_mask`).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

from pydem_tpu_torch.core import slope_direction as sd
from pydem_tpu_torch.ops import _build, flood
from pydem_tpu_torch.profiling import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the masks of the CPU and the card tests
MASKS = ("empty", "full", "single", "checker", "spiral", "sea", "random 0.3",
         "random 0.45", "random 0.6")


def _spiral(n, m):
    """A one-pixel-wide clockwise spiral from the corner inwards, its arms
    a pixel apart: one component with the longest path a canvas holds."""
    g = np.zeros((n, m), bool)
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))

    def inside(i, j):
        return 0 <= i < n and 0 <= j < m

    def free(i, j, d):
        a, b = i + steps[d][0], j + steps[d][1]
        c, e = a + steps[d][0], b + steps[d][1]
        return (inside(a, b) and not g[a, b]
                and not (inside(c, e) and g[c, e]))

    i = j = d = 0
    g[0, 0] = True
    while True:
        if not free(i, j, d):
            d = (d + 1) % 4
            if not free(i, j, d):
                return g
        i, j = i + steps[d][0], j + steps[d][1]
        g[i, j] = True


def _sea(n, m, seed):
    """The lower half of an fBm surface: a ragged sea with islands and
    bays, as the NaN of a coastal tile."""
    rng = np.random.RandomState(seed)
    k = np.hypot(np.fft.fftfreq(n)[:, None], np.fft.rfftfreq(m)[None, :])
    k[0, 0] = 1.0
    amp = k ** -1.8
    amp[0, 0] = 0.0
    z = np.fft.irfft2(amp * (rng.randn(*amp.shape)
                             + 1j * rng.randn(*amp.shape)), s=(n, m))
    return z < np.median(z)


def flood_mask(kind, n, m, seed=0):
    """An ``(n, m)`` numpy bool mask of one of :data:`MASKS`."""
    if kind == "empty":
        return np.zeros((n, m), bool)
    if kind == "full":
        return np.ones((n, m), bool)
    if kind == "single":
        g = np.zeros((n, m), bool)
        g[n // 2, m // 3] = True
        return g
    if kind == "checker":  # neighbours only across corners
        i, j = np.mgrid[:n, :m]
        return (i + j) % 2 == 0
    if kind == "spiral":
        return _spiral(n, m)
    if kind == "sea":
        return _sea(n, m, seed)
    density = float(kind.split()[1])
    return np.random.RandomState(seed).rand(n, m) < density


def flood_payload(n, m, dtype, seed=0):
    """Payload values, whole metres with ties, of ``dtype``."""
    rng = np.random.RandomState(seed + 1)
    return torch.tensor(np.round(rng.rand(n, m) * 50), dtype=dtype)


def scipy_flood(mask, payload):
    """The flood's ``(labels, rep)`` from ``scipy.ndimage.label`` with the
    8-connected structure: each component's smallest flat index, ``n * m``
    off the mask; the payload there, NaN off the mask."""
    n, m = mask.shape
    comp, count = ndimage.label(mask, structure=np.ones((3, 3), int))
    idx = np.arange(n * m).reshape(n, m)
    first = np.full(count + 1, n * m)
    if count:
        first[1:] = ndimage.minimum(idx, comp, np.arange(1, count + 1))
    lbl = first[comp]
    pay = payload.numpy().reshape(-1)
    rep = np.where(mask, pay[np.minimum(lbl, n * m - 1)], np.nan)
    return lbl, rep


def _equals_scipy(mask, payload):
    lbl, rep = sd.label_flood(torch.from_numpy(mask), payload)
    want_lbl, want_rep = scipy_flood(mask, payload)
    assert lbl.dtype == torch.int32 and rep.dtype == payload.dtype
    np.testing.assert_array_equal(lbl.numpy(), want_lbl)
    np.testing.assert_array_equal(rep.numpy(), want_rep.astype(
        rep.numpy().dtype))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_flood_equals_scipy(kind, dtype):
    """On a 70 x 97 canvas: not a multiple of the kernel's 32 x 32 tiles
    either way."""
    mask = flood_mask(kind, 70, 97)
    _equals_scipy(mask, flood_payload(70, 97, dtype))


@pytest.mark.parametrize("shape", [(1, 1), (1, 77), (77, 1), (2, 65),
                                   (65, 2), (64, 96)])
def test_eager_flood_equals_scipy_on_thin_canvases(shape):
    mask = flood_mask("random 0.6", *shape, seed=4)
    _equals_scipy(mask, flood_payload(*shape, torch.float32))


def _no_build(*_args, **_kwargs):
    raise AssertionError("the CPU path built or loaded a CUDA library")


@pytest.fixture
def no_cuda_library(monkeypatch):
    """Fail on any attempt to build, load or call a CUDA library, whether
    or not an earlier test in this process loaded one."""
    monkeypatch.setattr(_build, "build", _no_build)
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(flood, "_entry", _no_build)


@pytest.mark.parametrize("kind", ["empty", "single", "spiral", "sea"])
def test_cpu_takes_the_eager_loop(no_cuda_library, kind):
    """``label_flood`` of a CPU mask is the eager loop's: its counter
    ``flood_iters`` moves (one host read a sweep), the kernel's do not."""
    mask = torch.from_numpy(flood_mask(kind, 40, 50))
    payload = flood_payload(40, 50, torch.float64)
    before = {k: counters[k] for k in ("flood_kernel", "flood_launches",
                                       "flood_iters")}
    lbl, rep = sd.label_flood(mask, payload)
    iters = counters["flood_iters"] - before["flood_iters"]
    want_lbl, want_rep = sd._label_flood_eager(mask, payload)
    assert counters["flood_iters"] - before["flood_iters"] == 2 * iters
    assert iters >= 1
    assert counters["flood_kernel"] == before["flood_kernel"]
    assert counters["flood_launches"] == before["flood_launches"]
    assert torch.equal(lbl, want_lbl)
    assert torch.equal(rep.nan_to_num(-1.0), want_rep.nan_to_num(-1.0))


@pytest.mark.parametrize("mask,error", [
    (torch.zeros(4, 4, dtype=torch.bool), ValueError),        # on the CPU
    (torch.zeros(5, dtype=torch.bool), ValueError),
    (torch.zeros(2, 3, 3, dtype=torch.bool), ValueError),
    (torch.zeros(4, 4, dtype=torch.uint8), TypeError),
    (torch.zeros(4, 4), TypeError),
    # 2^31 pixels, a view of one element
    (torch.zeros(1, 1, dtype=torch.bool).expand(2 ** 16, 2 ** 15),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_cannot_run(no_cuda_library, mask,
                                                    error):
    before = counters["flood_kernel"], counters["flood_launches"]
    with pytest.raises(error):
        flood.flood_labels(mask)
    assert (counters["flood_kernel"], counters["flood_launches"]) == before


def test_imports_need_no_cuda_library():
    """A fresh interpreter imports the flood, its wrapper and the terrain
    step, and runs the flood on the CPU, with no way to build or load a
    CUDA library."""
    code = (
        "from pydem_tpu_torch.ops import _build\n"
        "_build.build = _build.load = None\n"
        "import torch\n"
        "from pydem_tpu_torch.core.slope_direction import label_flood\n"
        "from pydem_tpu_torch.ops import flood\n"
        "from pydem_tpu_torch.parallel import sharded\n"
        "mask = torch.rand(6, 7) < 0.5\n"
        "lbl, rep = label_flood(mask, torch.rand(6, 7))\n"
        "assert lbl.shape == (6, 7) and lbl.dtype == torch.int32\n")
    env = dict(os.environ, CUDA_HOME=os.devnull, PATH=os.defpath,
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
