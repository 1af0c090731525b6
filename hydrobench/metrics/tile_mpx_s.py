"""Pixels of every tile completed in the window over the window's length
(the straddling tile included), in millions a second (host clock)."""


def read(run):
    if not run.tiles:
        return None
    return sum(t.pixels for t in run.tiles) / run.window_s / 1e6
