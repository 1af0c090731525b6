"""``torch.cuda.max_memory_allocated()`` over the window, in GB (1e9)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
