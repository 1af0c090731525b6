"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<digest>.so`` beside this file, on first use.  The
digest covers the source and the flags, so an edited source is rebuilt and a
built library is reused only for the text it was built from; the compiler's
report (registers, spills) is kept beside the library.  Nothing here
runs at import time: the CPU path never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")

# -fmad=false: no multiply-add contraction, so the kernel rounds exactly as
# its plain PyTorch version does; -Xptxas -v reports registers and shared
# memory per kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in %s/bin); the "
                       "CUDA kernels need the CUDA toolkit" % cuda_home)


def build(name):
    """Compile ``csrc/<name>.cu`` unless already built.

    Returns ``(library path, build seconds, nvcc log)``; seconds is 0.0
    when an existing build was reused, and the log is then the one kept from
    its build.
    """
    src = CSRC / ("%s.cu" % name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / ("lib%s-%s.so" % (name, digest))
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s%s"
                           % (src, proc.stdout, proc.stderr))
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load(name):
    """The built library for ``csrc/<name>.cu`` (built on first call)."""
    path, _seconds, _log = build(name)
    return ctypes.CDLL(str(path))
