"""The device's idle share of the traced window, %: 1 - (union of kernel,
memcpy and memset intervals) / window, from the profiler trace."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
