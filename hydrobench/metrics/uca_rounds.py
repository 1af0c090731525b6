"""Mean rounds a tile of the UCA solve (the program's exact
``uca_sweeps``)."""

import statistics


def read(run):
    rounds = [t.counters["uca_rounds"] for t in run.tiles
              if "uca_rounds" in t.counters]
    return statistics.fmean(rounds) if rounds else None
