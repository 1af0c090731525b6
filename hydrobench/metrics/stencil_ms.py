"""Mean ms a tile of the pre-stencils (slope, direction, flats, section,
receivers): CUDA events around ``sharded.terrain_pre``, or the chain's
``pre_program`` stage."""

from . import span_mean


def read(run):
    return span_mean(run, "stencil")
