"""Seconds from the process's start to the window's: import, loading the
built kernels, the tile pool and the warm tile (host clock)."""


def read(run):
    return run.setup_s
