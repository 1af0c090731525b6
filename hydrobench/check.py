"""The numbers that decide ``correct``: the program's planes of a tile
against the plain reference's, each number the worst over the tiles
compared.

A pixel counts as off where one side is NaN and the other not, or where
the two differ by more than the number's own tolerance: 1e-3 rad of flow
direction (circular), 1e-3 of the reference's slope or area, 0.01 of TWI
(stored x10, so 1e-3 of its logarithm).  Those sit
above float32's rounding of each formula and far below what a wrong
routing or a lower precision gives.

Where float32 and float64 break a tie between two facets differently
(a filled flat's drop is 1 mm), a pixel's flow, and all the area above
it, goes down another neighbour: a whole river can move, legitimately.
And a flow that runs exactly along a grid axis in float64 runs 1e-7 rad
off it in float32 (pi/2 rounds), so a sliver of ~1e-7 of a river lands on
the pixel beside it: on a pixel of one or two cells that is a large
relative error, on a river a negligible one.  So the area's largest error,
``uca_river_rel_max``, is taken over the *clean river* pixels: those whose
reference area is at least ``river_cells`` pixels' worth and that no pixel
whose direction differs by more than 1e-5 rad (or whose NaN-ness or flat
flag differs), nor any of its 8 neighbours, sends area to through the
reference's drainage graph.  There the two sides sum the same areas along
the same paths and differ by rounding, so an altered answer shows.  Where
under 1% of the river pixels are clean the number reads infinite: it then
vouches for nothing (a tile without rivers, only a tiny rehearsal's, reads
0).  The limits, and the readings they were set from, are
in each configuration's ``check`` block and in ``PERF.md``.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage

TOL = {"direction": 1e-3, "mag": 1e-3, "uca": 1e-3, "twi": 1e-2}
SEED_RAD = 1e-5


def _f64(a):
    return np.asarray(a, dtype=np.float64)


def _gap(prog, ref, plane):
    p, r = _f64(prog), _f64(ref)
    with np.errstate(invalid="ignore"):
        d = np.abs(p - r)
        if plane == "direction":
            d = np.minimum(d, 2 * np.pi - d)
        if plane in ("mag", "uca"):
            d = d / np.maximum(np.abs(r), 1e-300)
    return d, np.isnan(p) != np.isnan(r)


def _off(prog, ref, plane):
    d, nan_diff = _gap(prog, ref, plane)
    with np.errstate(invalid="ignore"):
        return nan_diff | (d > TOL[plane])


def numbers(prog, ref, river_cells):
    """``{name: value}`` for one tile: ``prog`` holds the program's host
    planes by name, ``ref`` the reference's (:class:`Planes`, with the
    drainage graph's ``downstream`` and the smallest pixel's
    ``cell_area``)."""
    out = {}
    for plane in prog:
        if plane == "flats":
            out["flats_diff"] = int((np.asarray(prog[plane]) !=
                                     np.asarray(ref[plane])).sum())
            continue
        out[plane + "_off_share"] = float(_off(prog[plane], ref[plane],
                                               plane).mean())
    if "uca" in prog:
        d, nan_diff = _gap(prog["direction"], ref["direction"], "direction")
        with np.errstate(invalid="ignore"):
            seeds = nan_diff | (d > SEED_RAD)
        if "flats" in prog:
            seeds |= np.asarray(prog["flats"]) != np.asarray(ref["flats"])
        seeds = scipy.ndimage.binary_dilation(seeds, np.ones((3, 3), bool))
        with np.errstate(invalid="ignore"):
            river = _f64(ref["uca"]) >= river_cells * ref.cell_area
        clean = river & ~ref.downstream(seeds)
        rel, nan_diff = _gap(prog["uca"], ref["uca"], "uca")
        rel = np.where(nan_diff, np.inf, np.nan_to_num(rel, nan=0.0))[clean]
        share = clean.sum() / river.sum() if river.any() else 1.0
        out["uca_river_rel_max"] = (float("inf") if share < 0.01
                                    else float(rel.max(initial=0.0)))
        out["clean_river_share"] = float(share)
    return out


def worst(per_tile):
    """The largest reading of each number over the tiles compared."""
    out = {}
    for nums in per_tile:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(values, limits):
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit; a number without a reading fails."""
    checks = {k: {"value": values.get(k, float("inf")), "limit": lim}
              for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
