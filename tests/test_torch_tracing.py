"""The port's spans and counters (``pydem_tpu_torch.profiling``) on the
benchmarked path, ``parallel.sharded.terrain_step``, on the CPU: off
without a recording, one record a step with each span once under its
parent, the host-read counters against the rounds and the flood, the
outputs unchanged, and the ``pydem::`` ranges of a ``torch.profiler``
trace nested as the parents say."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pydem_tpu_torch import fixtures, profiling
from pydem_tpu_torch.ops import uca_block as ub
from pydem_tpu_torch.parallel import sharded

torch.set_num_threads(1)

N = 256
CONE, RING_FLAT, SPIRAL = 0, 13, 30

# span -> its parent in one terrain_step(uca_solver="blocked")
PARENTS = {"terrain_step": None, "pre": "terrain_step", "slopes": "pre",
           "flats": "pre", "label_flood": "flats", "section": "pre",
           "receivers": "pre", "pad": "terrain_step",
           "solve": "terrain_step", "compact": "solve",
           "post": "terrain_step"}


def _args(case, n=N):
    elev = torch.from_numpy(fixtures.get_test_case(case, n)[0])
    one = np.ones(n)
    return elev, one[:-1], one[:-1], one, one


def _step(case, n=N, **kw):
    return sharded.terrain_step(*_args(case, n), uca_solver="blocked", **kw)


def _recorded(case, steps=1, n=N):
    with profiling.recording("cpu") as rec:
        outs = [_step(case, n) for _ in range(steps)]
    return outs, rec.records()


def _ranges(prof):
    """``[(name without the prefix, start us, end us)]`` of the trace's
    ``pydem::`` ranges."""
    return [(e.name[len(profiling.PREFIX):], e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.name.startswith(profiling.PREFIX)]


def test_spans_are_off_without_a_recording():
    assert profiling._recorder is None
    # off, a span is one shared null context: nothing is made or kept
    assert profiling.span("pre") is profiling.span("solve")
    reads = profiling.counters["solve_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _step(CONE)
    assert _ranges(prof) == []
    assert profiling._recorder is None
    # the counters count all the same
    assert profiling.counters["solve_reads"] - reads == \
        -(-out["uca_sweeps"] // 4)


def test_each_span_once_a_record_under_its_parent():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _outs, records = _recorded(RING_FLAT, steps=2)
    assert len(records) == 2
    for r in records:
        assert r["parents"] == PARENTS
        assert set(r["spans"]) == set(PARENTS)
        assert all(ms >= 0 for ms in r["spans"].values())
    names = [name for name, _a, _b in _ranges(prof)]
    assert sorted(names) == sorted(list(PARENTS) * 2)


@pytest.mark.parametrize("case,n,B", [(CONE, N, None), (RING_FLAT, N, None),
                                      (SPIRAL, 32, 8), (SPIRAL, 48, 16)])
def test_solve_reads_are_the_rounds_over_four(case, n, B):
    """In a step, or in a solve called alone (its own record, the solve
    outermost)."""
    before = profiling.counters["solve_reads"]
    if B is None:
        (out,), (record,) = _recorded(case, n=n)
        rounds = out["uca_sweeps"]
    else:
        _mag, _d, _f, W, base = sharded.terrain_pre(*_args(case, n))
        with profiling.recording("cpu") as rec:
            _area, rounds = ub.accumulate_blocked_gs(base, W, B=B)
        (record,) = rec.records()
        assert record["parents"] == {"solve": None, "compact": "solve"}
        assert rounds > 4
    reads = -(-rounds // 4)
    assert record["counters"]["solve_reads"] == reads
    assert profiling.counters["solve_reads"] - before == reads


@pytest.mark.parametrize("case", [CONE, RING_FLAT])
def test_flood_iters(case):
    """One min-sweep, hence one host read, where no flat is left; more on a
    plateau, the same count on every call."""
    (a, b), records = _recorded(case, steps=2)
    iters = [r["counters"]["flood_iters"] for r in records]
    if case == CONE:
        assert not a["flats"].any()
        assert iters == [1, 1]
    else:
        assert a["flats"].sum() > 1000
        assert iters[0] > 1 and iters[0] == iters[1]


@pytest.mark.parametrize("case", [CONE, RING_FLAT, SPIRAL])
def test_outputs_bitwise_with_and_without_a_recording(case):
    plain = _step(case, n=64)
    (traced,), _records = _recorded(case, n=64)
    assert plain["uca_sweeps"] == traced["uca_sweeps"]
    for key in ("mag", "direction", "flats", "uca", "twi"):
        assert torch.equal(torch.nan_to_num(plain[key]),
                           torch.nan_to_num(traced[key])), key
        assert torch.equal(plain[key].isnan(), traced[key].isnan()), key


def test_profiler_ranges_nest_as_the_parents_say():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _outs, records = _recorded(RING_FLAT, steps=2)
    ranges = _ranges(prof)
    steps = sorted((a, b) for name, a, b in ranges if name == "terrain_step")
    assert len(steps) == 2 and steps[0][1] <= steps[1][0]
    for name, a, b in ranges:
        parent = records[0]["parents"][name]
        if parent is None:
            continue
        around = [(pb - pa, p) for p, pa, pb in ranges
                  if pa <= a and b <= pb and (p, pa, pb) != (name, a, b)]
        # the parent is the innermost range around it
        assert (min(around)[0], parent) in around, (name, parent)


def test_counts_reach_the_open_record_only():
    """A count made with no span open reaches no record; a recording
    opened inside another gives the outer one back when it closes."""
    with profiling.recording("cpu") as outer:
        profiling.count("tracing_test")
        with profiling.span("here"):
            profiling.count("tracing_test", 2)
            with profiling.recording("cpu") as inner:
                with profiling.span("inner"):
                    profiling.count("tracing_test", 5)
            assert profiling._recorder is outer
            profiling.count("tracing_test", 3)
    assert profiling._recorder is None
    (record,) = outer.records()
    assert record["parents"] == {"here": None}
    assert record["counters"] == {"tracing_test": 5}
    (record,) = inner.records()
    assert record["parents"] == {"inner": None}
    assert record["counters"] == {"tracing_test": 5}
