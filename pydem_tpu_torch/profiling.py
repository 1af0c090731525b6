"""Observability: spans, counters and stage timers, on the profiler's clock.

- :func:`span` names a stretch of the program (``with span("solve"):``).
  It is off unless a :func:`recording` is open, and off it is one check of
  a module-level name that returns a shared null context.  Open, it opens
  a ``torch.profiler.record_function("pydem::<name>")`` range, so that a
  ``torch.profiler`` trace puts device time and idle gaps under the
  program's stages on the kernels' clock, and takes a start and an end
  mark: CUDA events on the device's current stream, or the host clock on
  the CPU.  The marks are resolved only when the records are read, after
  the caller has synchronised: no span synchronises, reads the device or
  changes what is enqueued.
- :func:`count` adds to :data:`counters`, always (tests read the host
  reads there whether or not a recording is open); under a recording it
  also adds to the record of the open span.
- :func:`recording` opens a :class:`Recorder`.  A span opened while no
  span is open starts a new record: one ``terrain_step`` is one record.
- :class:`StageTimer` accumulates host-clock seconds a stage
  (``ProcessManager`` returns them); each stage is also a span.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import time

import torch

logger = logging.getLogger(__name__)

PREFIX = "pydem::"

# every count() since the process started, by name
counters = collections.Counter()

_recorder = None  # the open Recorder, or None
_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters, one record per outermost span.  The spans of one
    thread: the program opens none on its worker threads."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._open = []  # names of the open spans, outermost first
        self._records = []  # ([(name, parent, start, end)], Counter)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def _ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def _count(self, name, n):
        if self._open:
            self._records[-1][1][name] += n

    def records(self):
        """One dict a record: ``{"spans": {name: ms}, "parents": {name:
        parent or None}, "counters": {name: n}}``; a span that ran twice in
        a record adds up.  Call after the device has finished the work."""
        out = []
        for spans, counts in self._records:
            ms, parents = collections.defaultdict(float), {}
            for name, parent, a, b in spans:
                ms[name] += self._ms(a, b)
                parents[name] = parent
            out.append({"spans": dict(ms), "parents": parents,
                        "counters": dict(counts)})
        return out


class _Span:
    __slots__ = ("rec", "name", "parent", "range", "start")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if not rec._open:
            rec._records.append(([], collections.Counter()))
        self.parent = rec._open[-1] if rec._open else None
        rec._open.append(self.name)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.start = rec._mark()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        end = rec._mark()
        self.range.__exit__(*exc)
        rec._open.pop()
        rec._records[-1][0].append((self.name, self.parent, self.start, end))
        return False


def span(name):
    """A context manager that times ``name`` under an open recording and
    does nothing otherwise."""
    if _recorder is None:
        return _OFF
    return _Span(_recorder, name)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    counters[name] += n
    if _recorder is not None:
        _recorder._count(name, n)


@contextlib.contextmanager
def recording(device):
    """Turn the spans on for the enclosed region and yield the
    :class:`Recorder` (CUDA events on a ``cuda`` device, the host clock
    otherwise)."""
    global _recorder
    prev, _recorder = _recorder, Recorder(device)
    try:
        yield _recorder
    finally:
        _recorder = prev


class StageTimer:
    """Accumulates wall-clock per named pipeline stage."""

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            with span(name):
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
