"""The output check: the reference is the program's arithmetic in
float64, its control in bfloat16 fails, and a run with the timed path
broken underneath comes out not correct."""
import time

import pytest
import torch

from hydrobench import check, geo, harness, manifest
from hydrobench.reference import terrain as ref
from hydrobench.terrain import fractal

BENCH = manifest.benchmark()
MERIT = [w["name"] for w in BENCH["workloads"]
         if manifest.cell(BENCH, w["name"])[1]["entry"] == "terrain_step"]
SHAPE = (96, 96)


def _cell(name, shape=SHAPE):
    _w, config, traffic = manifest.cell(BENCH, name)
    config = dict(config, shape=list(shape))
    return config, traffic, geo.tile_spacings(config)


@pytest.mark.parametrize("name", MERIT)
def test_reference_is_the_programs_arithmetic_in_float64(name):
    from pydem_tpu_torch.parallel.sharded import terrain_step

    config, traffic, sp = _cell(name)
    pool, _ = fractal.make_pool(traffic, config, 21, "cpu")
    for tile in pool[:2]:
        e = torch.from_numpy(tile.astype("float64"))
        got = terrain_step(e, *[torch.from_numpy(a) for a in sp],
                           uca_solver="blocked")
        want = ref.planes(e.numpy(), sp, config, "cpu")
        nums = check.numbers({k: got[k].numpy() for k in want}, want, 100)
        assert nums["flats_diff"] == 0 and nums["clean_river_share"] == 1
        assert nums["uca_river_rel_max"] < 1e-12
        for k in ("direction", "mag", "uca", "twi"):
            assert nums[k + "_off_share"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", MERIT)
def test_control_in_bfloat16_fails(name, seed):
    config, traffic, sp = _cell(name)
    pool, order = fractal.make_pool(traffic, config, seed, "cpu")
    per = []
    for pos in harness.sample_positions(seed, len(pool),
                                        config["check"]["tiles"]):
        tile = pool[order[pos]]
        want = ref.planes(tile, sp, config, "cpu")
        low = ref.planes(tile, sp, config, "cpu", torch.bfloat16)
        per.append(check.numbers({k: low[k] for k in ref.PLANES}, want,
                                 config["check"]["river_cells"]))
    ok, checks = check.judge(check.worst(per), config["check"]["limits"])
    assert not ok
    assert checks["flats_diff"]["value"] > 0


def _broken_run(name, monkeypatch, fault):
    """A rehearsal run of ``name`` with ``fault`` planted under the timed
    path; returns its ``correct``."""
    from pydem_tpu_torch.ops import uca_block
    from pydem_tpu_torch.parallel import sharded

    step = sharded.terrain_step
    if fault == "state unchanged":  # the solve returns its state as given
        monkeypatch.setattr(uca_block, "accumulate_blocked_gs",
                            lambda base, W, B=256, **kw: (base.clone(), 0))
    elif fault == "half left out":  # half the rows solved, the mean elsewhere
        def half(elev, *sp, **kw):
            n = elev.shape[0] // 2
            out = step(elev[:n], *(a[:n - 1] if len(a) == elev.shape[0] - 1
                                   else a[:n] for a in sp), **kw)
            full = {}
            for k, v in out.items():
                if not torch.is_tensor(v):
                    full[k] = v
                    continue
                fill = torch.full((elev.shape[0] - n,) + v.shape[1:],
                                  0, dtype=v.dtype) if v.dtype == torch.bool \
                    else torch.nanmean(v.double()).to(v.dtype).expand(
                        (elev.shape[0] - n,) + v.shape[1:])
                full[k] = torch.cat([v, fill])
            return full
        monkeypatch.setattr(sharded, "terrain_step", half)
    elif fault == "answer altered":  # the outlet's area, where it is made
        def altered(*a, **kw):
            out = step(*a, **kw)
            u = out["uca"].clone()
            u.view(-1)[torch.argmax(torch.nan_to_num(u, nan=-1.0))] *= 2
            out["uca"] = u
            return out
        monkeypatch.setattr(sharded, "terrain_step", altered)
    run, kept, pool, order = harness.run(BENCH, name, 4, 0.3, False, "cpu",
                                         time.perf_counter(), shape=(192, 192))
    ok, _checks, _ = harness.compare(run.config, kept, pool, order,
                                     geo.tile_spacings(run.config), "cpu")
    return ok


@pytest.mark.parametrize("fault", ["none", "state unchanged",
                                   "half left out", "answer altered"])
@pytest.mark.parametrize("name", MERIT)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    assert _broken_run(name, monkeypatch, fault) == (fault == "none")
