"""Observability: stage timers and device profiler traces.

Port of ``pydem_tpu/profiling.py``: :class:`StageTimer` (used by
ProcessManager) is a copy; :func:`device_trace` and :func:`annotate` wrap
``torch.profiler`` where the JAX package wraps ``jax.profiler``.  The trace
is a Chrome-trace JSON file (``chrome://tracing``, Perfetto).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named pipeline stage."""

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            logger.info("stage %s: %.3fs", name, dt)

    def report(self):
        return dict(self.stages)

    def dump(self, fn):
        with open(fn, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def device_trace(logdir=None):
    """Capture a ``torch.profiler`` trace (CPU ops, and CUDA kernels when a
    GPU is present) for the enclosed region into ``<logdir>/trace.json``.
    ``logdir`` defaults to a fresh temporary directory; it is yielded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="pydem_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        logger.info("device trace written to %s", logdir)


def annotate(name):
    """Decorator adding a named ``record_function`` range around a function
    (shows up in profiler timelines)."""
    import functools

    from torch.profiler import record_function

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)

        return wrapper

    return deco
