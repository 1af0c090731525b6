"""The native (C++) pit-path carve, built with g++ on first use.

Port of ``pydem_tpu/native/__init__.py``.  ``conditioning.cpp`` compiles
into ``build/libconditioning-<digest>.so`` beside this file, where the
digest covers the source and the flags, and loads with ctypes.  Nothing is
built at import time.  :func:`get_lib` returns None when g++ fails (callers
then run the numpy loop, which is the semantics reference);
:func:`build` raises instead.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("conditioning.cpp")
BUILD_DIR = Path(__file__).with_name("build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build():
    """Compile ``conditioning.cpp`` unless already built.  Returns
    ``(library path, build seconds)``, seconds 0.0 when reused; raises
    ``RuntimeError`` if g++ fails."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / ("libconditioning-%s.so" % digest)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except OSError as e:  # no g++ on PATH
        raise RuntimeError("g++ could not run: %s" % e) from e
    if proc.returncode != 0:
        raise RuntimeError("g++ failed on %s:\n%s%s"
                           % (SRC, proc.stdout, proc.stderr))
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out, time.perf_counter() - t0


@functools.cache
def _load():
    lib = ctypes.CDLL(str(build()[0]))
    lib.drain_pit_paths.restype = ctypes.c_int64
    lib.drain_pit_paths.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # e (mutated)
        ctypes.c_int64, ctypes.c_int64,    # n, m
        ctypes.POINTER(ctypes.c_double),   # dX
        ctypes.POINTER(ctypes.c_double),   # dY
        ctypes.POINTER(ctypes.c_int64),    # pits (sorted)
        ctypes.c_int64,                    # n_pits
        ctypes.c_int64,                    # max_iter
        ctypes.c_double, ctypes.c_double,  # max_dist, max_dist_XY
    ]
    return lib


def get_lib(required=False):
    """The loaded native library.  When it cannot be built: None, or with
    ``required`` the build's ``RuntimeError``."""
    try:
        return _load()
    except RuntimeError:
        if required:
            raise
        return None


def drain_pit_paths_native(elev, dX, dY, pits, max_iter, max_dist,
                           max_dist_XY, required=False):
    """Run the native carve in place on ``elev`` (float64, C-order).

    Returns the count of pits with nowhere to drain, or None when the
    library is unavailable and not ``required``.
    """
    lib = get_lib(required)
    if lib is None:
        return None
    e = np.ascontiguousarray(elev, "float64")
    if e is not elev:
        raise ValueError("elev must be a contiguous float64 array")
    dX = np.ascontiguousarray(dX, "float64")
    dY = np.ascontiguousarray(dY, "float64")
    pits = np.ascontiguousarray(pits, "int64")
    n, m = e.shape
    c_dbl = ctypes.POINTER(ctypes.c_double)
    warn = lib.drain_pit_paths(
        e.ctypes.data_as(c_dbl), n, m,
        dX.ctypes.data_as(c_dbl), dY.ctypes.data_as(c_dbl),
        pits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), pits.size,
        int(max_iter), float(max_dist or 0), float(max_dist_XY or 0))
    return int(warn)
