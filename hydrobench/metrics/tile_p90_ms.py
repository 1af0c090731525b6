"""The 90th percentile of the latency of all tiles of the window, ms
(host clock; ``statistics.quantiles``' exclusive method)."""

import statistics


def read(run):
    if len(run.tiles) < 2:
        return None
    return statistics.quantiles([t.latency_s * 1e3 for t in run.tiles],
                                n=10)[-1]
