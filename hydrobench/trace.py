"""Spans and the device trace of a traced run (``--trace 1``).

Spans are taken from the benchmark's own files, around the program's
calls: a wrapper set on a module attribute records CUDA events and a
``record_function`` range around the call.  It is installed only in a
traced run and removed after it.  The device trace is ``torch.profiler``
over the window's first seconds (:class:`Profiler`), written as a Chrome
trace under ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

WINDOW = "hydrobench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Spans:
    """Per-tile milliseconds of named spans: CUDA events on the card, the
    host clock on the CPU (the rehearsal)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open = []  # (span, start, end) of the current tile
        self.tiles = []  # {span: ms} a tile

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function("hydrobench::" + name):
            a = self._mark()
            try:
                yield
            finally:
                self.open.append((name, a, self._mark()))

    def end_tile(self):
        """Close the tile (after the device is synchronised)."""
        out = defaultdict(float)
        for name, a, b in self.open:
            out[name] += self._ms(a, b)
        self.tiles.append(dict(out))
        self.open = []


@contextlib.contextmanager
def wrapped(spans, targets):
    """Wrap each ``(module, attribute)`` of ``targets`` ({span: [...]}) in
    a span for the duration."""
    undo = []
    try:
        for name, places in targets.items():
            for mod_name, attr in places:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)

                def wrapper(*a, _fn=fn, _name=name, **kw):
                    with spans.span(_name):
                        return _fn(*a, **kw)

                functools.update_wrapper(wrapper, fn)
                setattr(mod, attr, wrapper)
                undo.append((mod, attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


class Profiler:
    """``torch.profiler`` from :meth:`start` to :meth:`stop`, the span
    between them a ``WINDOW`` range; ``events`` then holds the trace's
    complete events (Chrome trace dicts), read from a file under ``TMPDIR``
    that is deleted once read."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.window = torch.profiler.record_function(WINDOW)
        self.running = False
        self.events = []

    def start(self):
        self.prof.start()
        self.window.__enter__()
        self.running = True

    def stop(self):
        self.window.__exit__(None, None, None)
        self.prof.stop()
        self.running = False
        fd, path = tempfile.mkstemp(prefix="hydrobench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f).get("traceEvents", [])
                               if e.get("ph") == "X"]
        finally:
            os.unlink(path)


def short(kernel):
    """A kernel's name without ``void`` and ``at::native::``, cut to 160
    characters: enough to tell PyTorch's element-wise functors apart."""
    name = kernel.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:160]


def _union(intervals):
    """Merged, sorted ``[(start, end)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What the metrics read from a device trace: the traced window, the
    device's busy intervals in it, kernel time by span and by name, and the
    idle gaps by what the host was doing.  Times in seconds."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace has no %s range" % WINDOW)
        w = win[0]
        self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]  # microseconds
        self.main_tid = w.get("tid")
        self.window_s = w["dur"] * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.kernels = [e for e in dev if e.get("cat") == "kernel"]
        self.busy = _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"],
                                                       self.t1)) for e in dev)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.events = events

    def kernel_s_in(self, span):
        """``(seconds, calls)``: device seconds of the kernels launched
        inside the host ranges of ``span`` (a launch's correlation id ties
        it to its kernel), and the number of those ranges."""
        name = "hydrobench::" + span
        ranges = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid"))
                        for e in self.events if e.get("name") == name
                        and e.get("cat") == "user_annotation")
        if not ranges:
            return None, 0
        launches = sorted((e["ts"], e.get("tid"), e.get("args", {})
                           .get("correlation")) for e in self.events
                          if e.get("cat") in ("cuda_runtime", "cuda_driver"))
        corr, i = set(), 0
        for a, b, tid in ranges:
            while i < len(launches) and launches[i][0] < a:
                i += 1
            j = i
            while j < len(launches) and launches[j][0] <= b:
                if launches[j][1] == tid and launches[j][2] is not None:
                    corr.add(launches[j][2])
                j += 1
        return sum(k["dur"] for k in self.kernels
                   if k.get("args", {}).get("correlation") in corr) * 1e-6, \
            len(ranges)

    def device_ops(self, top=10):
        by = defaultdict(float)
        for k in self.kernels:
            by[short(k["name"])] += k["dur"] * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top=10):
        """Idle gaps of the device summed by the innermost host range open
        on the main thread at each gap's middle."""
        gaps, prev = [], self.t0
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted((e["ts"], -e["dur"], e["name"]) for e in self.events
                      if e.get("cat") in HOST_CATS and e.get("name")
                      and e.get("tid") == self.main_tid
                      and e.get("name") != WINDOW)
        by, stack, i = defaultdict(float), [], 0
        for a, b in gaps:
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                ts, neg, name = host[i]
                while stack and stack[-1][0] < ts:
                    stack.pop()
                stack.append((ts - neg, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            by[stack[-1][1] if stack else "(no host range)"] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:top]
