"""One reader a metric, ``metrics/<name>.py`` with ``read(run)``: the
metric's value from a :class:`hydrobench.harness.Run`, or None where the
run has nothing to read it from (the harness then leaves it out)."""

import statistics


def span_mean(run, span):
    """Mean ms a tile of ``span`` over the traced window's tiles, or None
    where no tile recorded it."""
    if not run.spans or not any(span in t for t in run.spans):
        return None
    return statistics.fmean(t.get(span, 0.0) for t in run.spans)
