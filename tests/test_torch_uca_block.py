"""pydem_tpu_torch.ops.uca_block on the CPU: the compact encoding, the plain
rounds (the CUDA kernels' twins: K1's ``gs_round_oriented_plain`` in the
TPU's Gauss-Seidel order, K2's ``block_round_plain``, and the sweep loop
``_relax_blocks`` both call) and the four blocked solvers, against the JAX
package (its Pallas kernels in interpret mode) and against a per-block
reference loop written the way the kernels run.
"""
import functools
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu import DEMProcessor, fixtures
from pydem_tpu.core import conditioning as j_cond
from pydem_tpu.core.receivers import receiver_weights, section_proportion
from pydem_tpu.core.slope_direction import find_flats_edges, slopes_directions
from pydem_tpu.core.uca import accumulate, base_area
from pydem_tpu.ops import uca_block as j_ub
from pydem_tpu_torch.convert import state_from_numpy
from pydem_tpu_torch.core import receivers as t_rec
from pydem_tpu_torch.core import slope_direction as t_sd
from pydem_tpu_torch.core.stencil import NEIGHBOR_OFFSETS, dilate
from pydem_tpu_torch.ops import uca_block as t_ub
from pydem_tpu_torch.profiling import counters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_state(case, n=32):
    """The JAX package's receiver planes and base area for a fixture."""
    elev, _a, _u = fixtures.get_test_case(case, n)
    elev = jnp.asarray(elev)
    dX = dY = jnp.ones(n - 1)
    mag, direction = slopes_directions(elev, dX, dY)
    flats = find_flats_edges(elev, mag, direction)
    direction = jnp.where(flats, -1, direction)
    section, proportion = section_proportion(direction, flats, dX, dY)
    W = receiver_weights(section, proportion, elev)
    base = base_area(jnp.ones(n), jnp.ones(n), elev.shape, elev.dtype)
    return W, base


@pytest.mark.parametrize("case", [13, 33, 5, 24])
def test_compact_from_dense_matches_and_roundtrips(case):
    W, _base = _jax_state(case)
    K, W1 = j_ub.compact_from_dense(W)
    s = state_from_numpy(dict(W=np.asarray(W)), "cpu", torch.float64)
    tK, tW1 = t_ub.compact_from_dense(s["W"])
    assert tK.dtype == torch.uint8
    np.testing.assert_array_equal(tK.numpy().astype(np.int32), np.asarray(K))
    np.testing.assert_array_equal(tW1.numpy(), np.asarray(W1))
    np.testing.assert_array_equal(t_ub.expand_compact(tK, tW1).numpy(),
                                  np.asarray(W))


@pytest.mark.parametrize("case", [33, 5, 24])
def test_blocked_matches_jax_blocked_and_jacobi(case):
    W, base = _jax_state(case)
    ref, _sweeps = accumulate(base, W)
    jgot, jrounds = j_ub.accumulate_blocked_gs(base, W, B=8, inner_max=8,
                                               interpret=True)
    s = state_from_numpy(dict(W=np.asarray(W), base=np.asarray(base)), "cpu",
                         torch.float64)
    got, rounds = t_ub.accumulate_blocked_gs(s["base"], s["W"], B=8,
                                             inner_max=8)
    assert rounds == int(jrounds) >= 1
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(jgot),
                                         decimal=10)
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(ref),
                                         decimal=10)


def _dense(K, W1):
    k1, k2 = K >> 4, K & 15
    w2 = np.where(k2 != 15, 1 - W1, 0)
    return np.stack([np.where(k1 == k, W1, 0) + np.where(k2 == k, w2, 0)
                     for k in range(8)])


def _round_reference(x, dense, base, prev, B, inner_max, with_sweeps=False):
    """One round as the CUDA kernels run it: block by block, each with its
    own convergence loop (numpy), on dense weight planes; ``prev`` None
    visits every block (K2), else the frontier of K1.  With ``with_sweeps``
    the sweeps each block took are returned too."""
    n, m = x.shape
    nb_i, nb_j = n // B, m // B
    xp = np.pad(x, 1)
    wp = np.pad(dense, ((0, 0), (1, 1), (1, 1)))
    out, chg = x.copy(), np.zeros((nb_i, nb_j), np.int32)
    sweeps = np.zeros((nb_i, nb_j), np.int32)
    for bi in range(nb_i):
        for bj in range(nb_j):
            if prev is not None and not prev[max(bi - 1, 0): bi + 2,
                                             max(bj - 1, 0): bj + 2].any():
                continue
            win = xp[bi * B: bi * B + B + 2, bj * B: bj * B + B + 2].copy()
            w = wp[:, bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
            bb = base[bi * B: bi * B + B, bj * B: bj * B + B]
            x0 = win[1:-1, 1:-1].copy()
            it, changed = 0, True
            while it < inner_max and changed:
                for _ in range(4):
                    acc = bb
                    for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                        sl = (slice(1 - di, 1 - di + B),
                              slice(1 - dj, 1 - dj + B))
                        acc = acc + w[k][sl] * win[sl]
                    changed = bool((acc != win[1:-1, 1:-1]).any())
                    win[1:-1, 1:-1] = acc
                it += 4
            out[bi * B: bi * B + B, bj * B: bj * B + B] = win[1:-1, 1:-1]
            chg[bi, bj] = int((win[1:-1, 1:-1] != x0).any())
            sweeps[bi, bj] = it
    return (out, chg, sweeps) if with_sweeps else (out, chg)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("inner_max", [6, 20])
@pytest.mark.parametrize("prev_kind", ["ones", "sparse", "zeros"])
def test_plain_round_matches_per_block_reference(dtype, inner_max, prev_kind):
    """The plain rounds' sweep loop over K1's frontier (the blocks whose 3×3
    block neighbourhood has a flag) is bitwise the per-block loop of the
    kernel, frontier skip, cap and flags included, on a non-square
    canvas."""
    B, n, m = 8, 32, 48
    elev, _a, _u = fixtures.get_test_case(30, 48)
    elev = torch.from_numpy(elev[:n, :m].astype(dtype))
    ones = torch.ones(n - 1, dtype=elev.dtype)
    mag, direction = t_sd.slopes_directions(elev, ones, ones)
    flats = t_sd.find_flats_edges(elev, mag)
    direction = torch.where(flats, -1, direction)
    section, proportion = t_rec.section_proportion(direction, flats, ones,
                                                   ones)
    W = t_rec.receiver_weights(section, proportion, elev)
    rng = np.random.RandomState(3)
    base = rng.uniform(0.5, 1.5, (n, m)).astype(dtype)
    x = (base + rng.uniform(0, 20, (n, m))).astype(dtype)
    prev = {"ones": np.ones((n // B, m // B), np.int32),
            "sparse": (rng.uniform(size=(n // B, m // B)) < 0.2)
            .astype(np.int32),
            "zeros": np.zeros((n // B, m // B), np.int32)}[prev_kind]
    K, W1 = t_ub.compact_from_dense(W)
    want, want_chg = _round_reference(x, _dense(K.numpy(), W1.numpy()), base,
                                      prev, B, inner_max)
    got, chg = t_ub._relax_blocks(
        torch.from_numpy(x), t_ub.expand_compact(K, W1),
        torch.from_numpy(base), dilate(torch.from_numpy(prev) != 0), B=B,
        inner_max=inner_max)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(chg.numpy(), want_chg)


def test_cpu_round_runs_plain_and_counts_no_launch():
    W, base = _jax_state(33)
    s = state_from_numpy(dict(W=np.asarray(W), base=np.asarray(base)), "cpu",
                         torch.float64)
    before = t_ub.launch_count(t_ub.gs_round_oriented)
    t_ub.accumulate_blocked_gs(s["base"], s["W"], B=8)
    assert t_ub.launch_count(t_ub.gs_round_oriented) == before == 0


def test_round_rejects_bad_arguments():
    x = torch.zeros((16, 16), dtype=torch.float64)
    K = torch.full((16, 16), 255, dtype=torch.uint8)
    prev = torch.ones((2, 2), dtype=torch.int32)
    kw = dict(B=8, inner_max=8)
    with pytest.raises(ValueError, match="multiple"):
        t_ub.gs_round_oriented(x[:12], K[:12], x[:12], x[:12], 0, prev=prev,
                               **kw)
    with pytest.raises(TypeError, match="uint8"):
        t_ub.gs_round_oriented(x, K.int(), x, x, 0, prev=prev, **kw)
    with pytest.raises(TypeError, match="int32"):
        t_ub.gs_round_oriented(x, K, x, x, 0, prev=prev.long(), **kw)
    with pytest.raises(ValueError, match="prev has shape"):
        t_ub.gs_round_oriented(x, K, x, x, 0, prev=prev[:1], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        t_ub.gs_round_oriented(x.to("meta"), K, x, x, 0, prev=prev, **kw)
    with pytest.raises(ValueError, match="padded"):
        t_ub.accumulate_blocked_gs(x[:12], torch.zeros((8, 12, 16)), B=8)


def test_imports_and_runs_without_nvcc():
    """Importing the kernel's module needs no CUDA toolkit: the build runs
    only when a CUDA tensor reaches the wrapper."""
    code = (
        "import shutil, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "from pydem_tpu_torch.ops import uca_block as u\n"
        "base = torch.ones((16, 16), dtype=torch.float64)\n"
        "area, rounds = u.accumulate_blocked_gs(base, torch.zeros((8, 16, 16),"
        " dtype=torch.float64), B=8)\n"
        "assert torch.equal(area, base) and rounds == 1\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(REPO, "no-cuda-here"), PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("inner_max", [6, 20])
def test_block_round_plain_matches_per_block_reference(dtype, inner_max):
    """K2's plain round is bitwise the per-block loop on dense planes with
    more than two outgoing weights per pixel, which the compact encoding
    cannot hold."""
    B, n, m = 8, 32, 48
    rng = np.random.RandomState(9)
    W = rng.uniform(0, 0.15, (8, n, m)).astype(dtype)
    W[:, rng.uniform(size=(n, m)) < 0.1] = 0  # some pixels send nothing
    assert ((W > 0).sum(0) >= 3).mean() > 0.8
    base = rng.uniform(0.5, 1.5, (n, m)).astype(dtype)
    x = (base + rng.uniform(0, 5, (n, m))).astype(dtype)
    want, want_chg = _round_reference(x, W, base, None, B, inner_max)
    for fn in (t_ub.block_round_plain, t_ub.block_round):
        got, chg = fn(torch.from_numpy(x), torch.from_numpy(W),
                      torch.from_numpy(base), B=B, inner_max=inner_max)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(chg.numpy(), want_chg)
    # the CPU runs the plain round
    assert t_ub.launch_count(t_ub.block_round) == 0


def _pit_inputs(case, n=32):
    """W, base and the host pit links of a fixture with its pits left in
    (tests/test_uca_block.py's setup)."""
    elev, _a, _u = fixtures.get_test_case(case, n)
    dp = DEMProcessor(elev=elev, fill_flats=False, drain_pits_path=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp.calc_slopes_directions()
        ps, pd, pw, _flats, _mag = j_cond.connectivity_pits(
            dp.flats, dp.elev, dp.mag, dp.dX, dp.dY)
    keep = pw > 1e-8
    section, proportion = section_proportion(
        jnp.asarray(dp.direction), jnp.asarray(dp.flats),
        jnp.asarray(dp.dX), jnp.asarray(dp.dY))
    W = receiver_weights(section, proportion, jnp.asarray(dp.elev))
    base = base_area(jnp.asarray(dp.dX2), jnp.asarray(dp.dY2), elev.shape,
                     jnp.float64)
    return W, base, ps[keep], pd[keep], pw[keep]


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", [13, 16])
def test_blocked_pits_gs_matches_jax(case):
    """K1 with the pit fold == the JAX Gauss-Seidel solver (interpret mode)
    and the JAX jacobi solve with the same links."""
    W, base, ps, pd, pw = _pit_inputs(case)
    assert ps.size
    links = [jnp.asarray(a) for a in (ps, pd, pw)]
    want, want_rounds = j_ub.accumulate_blocked_pits_gs(
        base, W, *links, B=8, inner_max=8, interpret=True)
    ref, _sweeps = accumulate(base, W, *links)
    got, rounds = t_ub.accumulate_blocked_pits_gs(*_torch(base, W, ps, pd,
                                                          pw), B=8,
                                                  inner_max=8)
    assert rounds == int(want_rounds) >= 2
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=8)
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(ref),
                                         decimal=8)


@pytest.mark.parametrize("case", [33, 5, 30, 13])
@pytest.mark.parametrize("inner_max", [8, None])
def test_k2_blocked_matches_jax(case, inner_max):
    """K2's solver == JAX accumulate_blocked (interpret mode): values and
    the number of rounds (both are block-Jacobi)."""
    W, base = _jax_state(case)
    want, want_rounds = j_ub.accumulate_blocked(base, W, B=8,
                                                inner_max=inner_max,
                                                interpret=True)
    got, rounds = t_ub.accumulate_blocked(*_torch(base, W), B=8,
                                          inner_max=inner_max)
    assert rounds == int(want_rounds)
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


@pytest.mark.parametrize("case", [13, 16])
def test_k2_blocked_pits_matches_jax(case):
    """K2 with pit links == JAX accumulate_blocked_pits (interpret mode):
    values and rounds, by its rule (a fold every round, stop when a round
    leaves the canvas unchanged)."""
    W, base, ps, pd, pw = _pit_inputs(case)
    links = [jnp.asarray(a) for a in (ps, pd, pw)]
    want, want_rounds = j_ub.accumulate_blocked_pits(
        base, W, *links, B=8, inner_max=8, interpret=True)
    got, rounds = t_ub.accumulate_blocked_pits(*_torch(base, W, ps, pd, pw),
                                               B=8, inner_max=8)
    assert rounds == int(want_rounds) >= 2
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


def test_block_round_rejects_bad_arguments():
    x = torch.zeros((16, 16), dtype=torch.float64)
    W = torch.zeros((8, 16, 16), dtype=torch.float64)
    kw = dict(B=8, inner_max=8)
    with pytest.raises(ValueError, match="multiple"):
        t_ub.block_round(x[:12], W[:, :12], x[:12], **kw)
    with pytest.raises(ValueError, match="8 weight planes"):
        t_ub.block_round(x, W[:4], x, **kw)
    with pytest.raises(TypeError, match="W is torch.float32"):
        t_ub.block_round(x, W.float(), x, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        t_ub.block_round(x.to("meta"), W, x, **kw)
    with pytest.raises(ValueError, match="padded"):
        t_ub.accumulate_blocked(x[:12], W[:, :12], B=8)


# -- the kernels' in-block activity skip, modelled on the CPU ---------------
#
# Inside a block visit the CUDA kernels keep the x window in two buffers and
# give every warp's strip of pixels a "changed in the last sweep" flag, in
# two sets.  A strip is recomputed only if a strip of its 3x3 strip
# neighbourhood changed in the sweep before; else its pixels in the buffer
# being written are left as they are.  The model below runs that protocol
# with torch ops; it must give the plain round's values, flags and sweep
# counts bit for bit.

def _strip_shape(B):
    """(rows, columns) of a warp's strip in the kernels at block size B up
    to 64 (``Shape<B>`` in ``csrc/uca_block.cu``): lanes across min(B, 32)
    columns, R = 8 (B = 64), 4 (16, 32) or 2 (8) rows a thread."""
    rows_per_thread = 8 if B >= 64 else (4 if B >= 16 else 2)
    width = min(B, 32)
    return rows_per_thread * (32 // width), width


def _strip_relax(win, w_in, bse, B, inner_max):
    """One block visit by the strip protocol.  ``win`` (B+2, B+2) is the x
    window with its halo, ``w_in`` (8, B+2, B+2) the padded weight windows,
    ``bse`` (B, B).  Returns (values, sweeps, strip-sweeps skipped)."""
    sh, sw = _strip_shape(B)
    sr, sc = B // sh, B // sw
    buf = [win.clone(), win.clone()]
    # the first sweep finds every strip "changed"
    flags = [torch.ones((sr, sc), dtype=torch.bool),
             torch.zeros((sr, sc), dtype=torch.bool)]
    w_k = [w_in[k, 1 - di: 1 - di + B, 1 - dj: 1 - dj + B]
           for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS)]
    sweep = skipped = 0
    changed = True
    while sweep < inner_max and changed:
        for _ in range(4):
            cur, nxt = buf[sweep & 1], buf[(sweep + 1) & 1]
            rd, wr = flags[sweep & 1], flags[(sweep + 1) & 1]
            # strips beyond the block's rim do not exist: the halo is frozen
            active = torch.nn.functional.max_pool2d(
                rd[None, None].float(), 3, 1, 1)[0, 0] > 0
            acc = bse
            for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                acc = acc + w_k[k] * cur[1 - di: 1 - di + B,
                                         1 - dj: 1 - dj + B]
            moved = (acc != cur[1:-1, 1:-1]).view(sr, sh, sc, sw)
            wr.copy_(moved.any(3).any(1) & active)
            px = active.repeat_interleave(sh, 0).repeat_interleave(sw, 1)
            # a skipped strip keeps what the buffer held two sweeps ago
            nxt[1:-1, 1:-1] = torch.where(px, acc, nxt[1:-1, 1:-1])
            skipped += int((~active).sum())
            sweep += 1
        changed = bool(wr.any())  # the flags of the 4th sweep
    return buf[sweep & 1][1:-1, 1:-1], sweep, skipped


def _strip_round(x, dense, base, prev, B, inner_max):
    """One round by the strip protocol; arguments as ``_round_reference``.
    Returns (x_new, chg, sweeps per block, strip-sweeps skipped)."""
    n, m = x.shape
    nb_i, nb_j = n // B, m // B
    xp = torch.nn.functional.pad(torch.from_numpy(x), (1, 1, 1, 1))
    wp = torch.nn.functional.pad(torch.from_numpy(dense), (1, 1, 1, 1))
    bt = torch.from_numpy(base)
    out = torch.from_numpy(x).clone()
    chg = np.zeros((nb_i, nb_j), np.int32)
    sweeps = np.zeros((nb_i, nb_j), np.int32)
    skipped = 0
    for bi in range(nb_i):
        for bj in range(nb_j):
            if prev is not None and not prev[max(bi - 1, 0): bi + 2,
                                             max(bj - 1, 0): bj + 2].any():
                continue
            rows = slice(bi * B, bi * B + B)
            cols = slice(bj * B, bj * B + B)
            win = xp[bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
            got, sweeps[bi, bj], skip = _strip_relax(
                win, wp[:, bi * B: bi * B + B + 2, bj * B: bj * B + B + 2],
                bt[rows, cols], B, inner_max)
            skipped += skip
            chg[bi, bj] = int((got != win[1:-1, 1:-1]).any())
            out[rows, cols] = got
    return out.numpy(), chg, sweeps, skipped


def _terrain_planes(n, m, dtype):
    """Dense receiver planes of fixture 30 cut to (n, m), by the port."""
    elev, _a, _u = fixtures.get_test_case(30, max(n, m))
    elev = torch.from_numpy(elev[:n, :m].astype(dtype))
    ones = torch.ones(n - 1, dtype=elev.dtype)
    mag, direction = t_sd.slopes_directions(elev, ones, ones)
    flats = t_sd.find_flats_edges(elev, mag)
    direction = torch.where(flats, -1, direction)
    section, proportion = t_rec.section_proportion(direction, flats, ones,
                                                   ones)
    return t_rec.receiver_weights(section, proportion, elev)


@pytest.mark.parametrize("start", ["base", "changed halo", "nan"])
@pytest.mark.parametrize("inner_kind", [4, 8, "2B+4"])
@pytest.mark.parametrize("planes", ["receivers", "dense random"])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_strip_skip_protocol_is_exact(B, planes, inner_kind, start):
    """The kernels' activity skip changes nothing: values, changed flags and
    sweeps per block equal the plain round's, also when the cap ends the
    visit, when only a wave from one changed halo moves, and with a NaN."""
    dtype = np.float32
    n, m = 2 * B, 3 * B
    inner_max = 2 * B + 4 if inner_kind == "2B+4" else inner_kind
    rng = np.random.RandomState(B + len(planes))
    base_t = torch.from_numpy(rng.uniform(0.5, 1.5, (n, m)).astype(dtype))
    if planes == "receivers":  # K1's contract
        K, W1 = t_ub.compact_from_dense(_terrain_planes(n, m, dtype))
        W = t_ub.expand_compact(K, W1)
        solve = t_ub.accumulate_blocked_gs
    else:  # K2's contract: any nonnegative weights, any number per pixel
        W = rng.uniform(0, 0.1, (8, n, m)).astype(dtype)
        W[:, rng.uniform(size=(n, m)) < 0.1] = 0
        W = torch.from_numpy(W)
        solve = t_ub.accumulate_blocked
    prev = None
    if start == "base":
        x = base_t.clone()
    else:
        x, _rounds = solve(base_t, W, B=B)
        x = x.clone()
        if start == "changed halo":
            # the last row of block (0, 1) moves: blocks (1, 0..2) see a
            # changed halo, and at most a wave crosses them
            x[B - 1, B: 2 * B] += 1
            if planes == "receivers":
                prev = np.zeros((n // B, m // B), np.int32)
                prev[0, 1] = 1
        else:
            x[B + B // 2, B // 3] = np.nan
    x, base, dense = x.numpy(), base_t.numpy(), W.numpy()

    got, chg, sweeps, skipped = _strip_round(x, dense, base, prev, B,
                                             inner_max)
    if planes == "receivers":
        prev_t = torch.from_numpy(
            np.ones((n // B, m // B), np.int32) if prev is None else prev)
        want, want_chg = t_ub._relax_blocks(
            torch.from_numpy(x), W, base_t, dilate(prev_t != 0), B=B,
            inner_max=inner_max)
    else:
        want, want_chg = t_ub.block_round_plain(
            torch.from_numpy(x), W, base_t, B=B, inner_max=inner_max)
    np.testing.assert_array_equal(got, want.numpy())  # NaNs in equal places
    np.testing.assert_array_equal(chg, want_chg.numpy())
    _ref, _ref_chg, want_sweeps = _round_reference(
        x, dense, base, prev, B, inner_max, with_sweeps=True)
    np.testing.assert_array_equal(sweeps, want_sweeps)
    if start == "nan":
        assert np.isnan(got).sum() > 1  # the NaN spread, and never settled
        assert sweeps[1, 0] == inner_max
    # the protocol did skip strips in this case; at B = 8 a block is one
    # strip, which skips only after a still sweep, and dense random weights
    # under a changed halo move every block through the first 8 sweeps
    one_strip = _strip_shape(B) == (B, B)
    if inner_max > 8 or (start == "changed halo"
                         and not (one_strip and planes == "dense random")):
        assert skipped > 0


# -- the K1 round loop: one host read per few rounds ------------------------

def _solve_reading_every_round(base, W, links, B, inner_max, max_rounds):
    """The K1 solve with the changed flags read on the host after every
    round, round r at orientation r % 4: what the solvers must return,
    canvas and round count."""
    n, m = base.shape
    K, W1 = t_ub.compact_from_dense(W)
    b_prev = base if links is None else links.add_to(base, base)
    prev = torch.ones((n // B, m // B), dtype=torch.int32)
    x, chg = t_ub.gs_round_oriented_plain(base, K, W1, b_prev, 0, B=B,
                                          inner_max=inner_max, prev=prev)
    rounds = 1
    while rounds < max_rounds and int(chg.sum()) > 0:
        if links is None:
            b, prev = base, chg
        else:
            b = links.add_to(base, x)
            prev = chg | t_ub._block_any(b != b_prev, B)
        x, chg = t_ub.gs_round_oriented_plain(x, K, W1, b, rounds % 4, B=B,
                                              inner_max=inner_max, prev=prev)
        b_prev = b
        rounds += 1
    return x, rounds


def _round_loop_inputs(name):
    """(base, W, links or None, B, inner_max, rounds to convergence)."""
    if name.startswith("no edges"):
        base = torch.ones((16, 16), dtype=torch.float64)
        W = torch.zeros((8, 16, 16), dtype=torch.float64)
        if name == "no edges":
            return base, W, None, 8, 8, 1
        if name == "no edges, no links":
            empty = torch.zeros(0, dtype=torch.int64)
            return base, W, (empty, empty, torch.zeros(0, dtype=base.dtype)), \
                8, 8, 1
        link = (torch.tensor([3]), torch.tensor([200]),
                torch.tensor([0.5], dtype=base.dtype))
        return base, W, link, 8, 8, 2
    case, B, inner_max, rounds = {
        "fixture 33, B=16": (33, 16, 36, 2),
        "fixture 33, B=8": (33, 8, 8, 4),
        "fixture 5, B=8": (5, 8, 8, 3),
        "fixture 24, B=8": (24, 8, 8, 6),
        "fixture 33, B=16, 4 sweeps": (33, 16, 4, 5),
        "fixture 13 pits, B=8": (13, 8, 8, 4),
        "fixture 13 pits, B=16": (13, 16, 36, 3),
        "fixture 16 pits, B=8, 4 sweeps": (16, 8, 4, 6),
    }[name]
    if "pits" in name:
        W, base, ps, pd, pw = _pit_inputs(case)
        base, W, ps, pd, pw = _torch(base, W, ps, pd, pw)
        return base, W, (ps, pd, pw), B, inner_max, rounds
    W, base = _jax_state(case)
    base, W = _torch(base, W)
    return base, W, None, B, inner_max, rounds


@pytest.mark.parametrize("max_rounds", [100_000, 1, 3, 4, 5])
@pytest.mark.parametrize("name", [
    "no edges", "no edges, no links", "no edges, one link",
    "fixture 33, B=16", "fixture 33, B=8", "fixture 5, B=8",
    "fixture 24, B=8", "fixture 33, B=16, 4 sweeps", "fixture 13 pits, B=8",
    "fixture 13 pits, B=16", "fixture 16 pits, B=8, 4 sweeps"])
def test_round_loop_equals_reading_every_round(name, max_rounds):
    """The solvers read the flags once per few rounds; canvas (bitwise) and
    round count are those of a loop that reads them every round, for round
    counts of 1, 2, multiples of 4 and others, with and without pit links,
    and when ``max_rounds`` ends the solve before it converged."""
    base, W, links, B, inner_max, converged_in = _round_loop_inputs(name)
    want, want_rounds = _solve_reading_every_round(
        base, W, None if links is None else t_ub.PitLinks(*links), B,
        inner_max, max_rounds)
    assert want_rounds == min(converged_in, max_rounds)

    calls = []

    def counting_round(*args, **kw):
        calls.append(1)
        return t_ub.gs_round_oriented_plain(*args, **kw)

    reads = counters["solve_reads"]
    kw = dict(B=B, inner_max=inner_max, max_rounds=max_rounds,
              round_fn=counting_round)
    if links is None:
        got, rounds = t_ub.accumulate_blocked_gs(base, W, **kw)
    else:
        got, rounds = t_ub.accumulate_blocked_pits_gs(base, W, *links, **kw)
    assert rounds == want_rounds
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # never past max_rounds, at most 3 rounds past the first still one, and
    # one read per batch of 4
    assert rounds <= len(calls) <= min(rounds + 3, max(max_rounds, 1))
    assert len(calls) == min(-(-rounds // 4) * 4, max(max_rounds, 1))
    assert counters["solve_reads"] - reads == -(-rounds // 4)


# -- K1 in the TPU's Gauss-Seidel order -------------------------------------

def _sequential_round(x, dense, base, prev, B, inner_max, o):
    """One round as the TPU kernel runs it: block after block in row-major
    order of the grid flipped by ``_FLIPS[o]``, each reading and writing one
    live canvas (numpy), with the frontier of ``prev`` (None: every
    block)."""
    n, m = x.shape
    nb_i, nb_j = n // B, m // B
    fi, fj = t_ub._FLIPS[o]
    xp = np.pad(x, 1)
    wp = np.pad(dense, ((0, 0), (1, 1), (1, 1)))
    chg = np.zeros((nb_i, nb_j), np.int32)
    for p in range(nb_i):
        for q in range(nb_j):
            bi = nb_i - 1 - p if fi else p
            bj = nb_j - 1 - q if fj else q
            if prev is not None and not prev[max(bi - 1, 0): bi + 2,
                                             max(bj - 1, 0): bj + 2].any():
                continue
            win = xp[bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
            w = wp[:, bi * B: bi * B + B + 2, bj * B: bj * B + B + 2]
            bb = base[bi * B: bi * B + B, bj * B: bj * B + B]
            x0 = win[1:-1, 1:-1].copy()
            it, changed = 0, True
            while it < inner_max and changed:
                for _ in range(4):
                    acc = bb
                    for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
                        sl = (slice(1 - di, 1 - di + B),
                              slice(1 - dj, 1 - dj + B))
                        acc = acc + w[k][sl] * win[sl]
                    changed = bool((acc != win[1:-1, 1:-1]).any())
                    win[1:-1, 1:-1] = acc  # into the live canvas
                it += 4
            chg[bi, bj] = int((win[1:-1, 1:-1] != x0).any())
    return xp[1:-1, 1:-1], chg


@pytest.mark.parametrize("nb", [(4, 5), (3, 1), (1, 4), (2, 2), (6, 6)])
@pytest.mark.parametrize("o", range(4))
def test_round_levels_follow_the_visit_order(o, nb):
    """Every block is on one level; a block's halo neighbours that the TPU
    visits before it are on lower levels and the later ones on higher; the
    blocks of a level are no halo neighbours of each other; a round is
    2(nb_i - 1) + nb_j levels on grids two or more blocks wide."""
    nb_i, nb_j = nb
    levels = t_ub.round_levels(nb_i, nb_j, o)
    flat = torch.cat(levels).tolist()
    assert sorted(flat) == list(range(nb_i * nb_j))
    assert all(t.dtype == torch.int32 and len(t) for t in levels)
    assert len(levels) == (2 * (nb_i - 1) + nb_j if nb_j > 1 else nb_i)
    level_of = {}
    for t, blocks in enumerate(levels):
        for b in blocks.tolist():
            level_of[divmod(b, nb_j)] = t
    fi, fj = t_ub._FLIPS[o]

    def visit(bi, bj):  # the position in the TPU's sequential grid
        p = nb_i - 1 - bi if fi else bi
        q = nb_j - 1 - bj if fj else bj
        return p * nb_j + q

    for (bi, bj), t in level_of.items():
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                other = (bi + di, bj + dj)
                if other == (bi, bj) or other not in level_of:
                    continue
                before = visit(*other) < visit(bi, bj)
                assert (level_of[other] < t) == before, (o, (bi, bj), other)
                assert level_of[other] != t


@pytest.mark.parametrize("prev_kind", ["ones", "sparse", "zeros"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("o", range(4))
def test_oriented_plain_round_matches_sequential_loop(o, dtype, prev_kind):
    """The plain level round is bitwise the sequential per-block loop over
    one live canvas in the grid's order at each orientation, frontier and
    flags included, on a non-square canvas with a few sweeps a visit."""
    B, n, m = 8, 32, 48
    W = _terrain_planes(n, m, dtype)
    K, W1 = t_ub.compact_from_dense(W)
    rng = np.random.RandomState(11 + o)
    base = rng.uniform(0.5, 1.5, (n, m)).astype(dtype)
    x = (base + rng.uniform(0, 20, (n, m))).astype(dtype)
    prev = {"ones": np.ones((n // B, m // B), np.int32),
            "sparse": (rng.uniform(size=(n // B, m // B)) < 0.2)
            .astype(np.int32),
            "zeros": np.zeros((n // B, m // B), np.int32)}[prev_kind]
    want, want_chg = _sequential_round(x, _dense(K.numpy(), W1.numpy()),
                                       base, prev, B, 12, o)
    got, chg = t_ub.gs_round_oriented(
        torch.from_numpy(x), K, W1, torch.from_numpy(base), o, B=B,
        inner_max=12, prev=torch.from_numpy(prev))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(chg.numpy(), want_chg)
    assert t_ub.launch_count(t_ub.gs_round_oriented) == 0  # the plain one
    if prev_kind == "ones":
        # Gauss-Seidel: the round differs from the block-Jacobi one (K2's
        # round on the same weights)
        jac, _c = t_ub.block_round_plain(torch.from_numpy(x),
                                         t_ub.expand_compact(K, W1),
                                         torch.from_numpy(base), B=B,
                                         inner_max=12)
        assert not torch.equal(jac, got)


@functools.lru_cache(maxsize=None)
def _jax_oriented_round(B, inner_max):
    return jax.jit(lambda xp, kp, wp, base, o, prev: j_ub.gs_round_oriented(
        xp, kp, wp, base, o, B=B, inner_max=inner_max, interpret=True,
        prev=prev))


@pytest.mark.parametrize("start", ["base", "mid-solve"])
@pytest.mark.parametrize("o", range(4))
def test_oriented_round_matches_jax(o, start):
    """``gs_round_oriented`` == the JAX ``gs_round_oriented`` (Pallas in
    interpret mode) at each orientation, from the base with every block
    dirty and from a mid-solve canvas with a sparse ``prev``: flags exact,
    values to 10 decimals (float64)."""
    B, inner_max = 8, 8
    W, base = _jax_state(5)
    n, m = base.shape
    K, W1 = j_ub.compact_from_dense(W)
    HR, HC = j_ub.HR, j_ub.HC
    pad = ((HR, HR), (HC, HC))
    kp = jnp.pad(K, pad, constant_values=255)
    wp = jnp.pad(W1, pad)
    rng = np.random.RandomState(17 + o)
    if start == "base":
        x = np.asarray(base)
        prev = np.ones((n // B, m // B), np.int32)
    else:
        # a canvas on its way (every relaxed block moves by far more than
        # an ulp: jitted on the CPU, XLA contracts the kernel's multiply-adds,
        # so a block at its fixed point may move by one ulp there and not
        # here) and two flags in opposite corners: 8 of the 16 blocks relax
        x = np.asarray(base) + rng.uniform(0, 20, (n, m))
        prev = np.zeros((n // B, m // B), np.int32)
        prev[0, 0] = prev[-1, -1] = 1
    xp_new, jchg = _jax_oriented_round(B, inner_max)(
        jnp.pad(jnp.asarray(x), pad), kp, wp, base, jnp.int32(o),
        jnp.asarray(prev))
    jx = np.asarray(xp_new)[HR: HR + n, HC: HC + m]
    tK, tW1 = t_ub.compact_from_dense(torch.from_numpy(np.asarray(W)))
    got, chg = t_ub.gs_round_oriented(
        torch.from_numpy(x), tK, tW1, torch.from_numpy(np.asarray(base)), o,
        B=B, inner_max=inner_max,
        prev=None if start == "base" else torch.from_numpy(prev))
    np.testing.assert_array_equal(chg.numpy(), np.asarray(jchg))
    assert int(chg.sum()) == (16 if start == "base" else 8)
    np.testing.assert_array_almost_equal(got.numpy(), jx, decimal=10)


def _cone_state(n=128):
    """The JAX package's receiver planes and base area of an n² cone."""
    from chip_smoke import make_cone

    elev = jnp.asarray(make_cone(n, "float64"))
    dX = dY = jnp.ones(n - 1)
    mag, direction = slopes_directions(elev, dX, dY)
    flats = find_flats_edges(elev, mag, direction)
    direction = jnp.where(flats, -1, direction)
    section, proportion = section_proportion(direction, flats, dX, dY)
    W = receiver_weights(section, proportion, elev)
    return W, base_area(jnp.ones(n), jnp.ones(n), elev.shape, elev.dtype)


@pytest.mark.parametrize("max_rounds", [None, 1, 2, 3])
@pytest.mark.parametrize("case", [33, 5, 24, 13, "cone 128"])
@pytest.mark.parametrize("solver", ["gs", "pits_gs"])
def test_gs_solvers_return_jax_rounds(solver, case, max_rounds):
    """``accumulate_blocked_gs`` and ``accumulate_blocked_pits_gs`` return
    exactly the JAX solvers' rounds (Pallas in interpret mode) at equal B
    and ``inner_max``, with values to 10 decimals: on fixtures at 32², B =
    8, and on the 128² cone at B = 16, where JAX takes 5 rounds and
    block-Jacobi (K2's solver on the same planes) 8; ``max_rounds`` cuts
    both alike."""
    if case == "cone 128":
        W, base = _cone_state()
        links = [np.zeros(0, np.int64)] * 2 + [np.zeros(0)]
        B, inner_max = 16, None
    else:
        W, base, *links = _pit_inputs(case)
        B, inner_max = 8, 8
    if solver == "gs":
        links = []
    elif case == 13:
        assert len(links[0])  # the fold has links to fold
    cap = {} if max_rounds is None else dict(max_rounds=max_rounds)
    jfn = getattr(j_ub, "accumulate_blocked_%s" % solver)
    want, want_rounds = jfn(base, W, *(jnp.asarray(a) for a in links), B=B,
                            inner_max=inner_max, interpret=True, **cap)
    fn = getattr(t_ub, "accumulate_blocked_%s" % solver)
    got, rounds = fn(*_torch(base, W, *links), B=B, inner_max=inner_max,
                     **cap)
    assert rounds == int(want_rounds)
    if max_rounds is not None:
        assert rounds <= max_rounds
    elif case == "cone 128":
        assert rounds == 5
        _x, jacobi = t_ub.accumulate_blocked(*_torch(base, W), B=B,
                                             round_fn=t_ub.block_round_plain)
        assert jacobi == 8
    np.testing.assert_array_almost_equal(got.numpy(), np.asarray(want),
                                         decimal=10)


def test_oriented_round_rejects_bad_arguments():
    x = torch.zeros((16, 16), dtype=torch.float64)
    K = torch.full((16, 16), 255, dtype=torch.uint8)
    prev = torch.ones((2, 2), dtype=torch.int32)
    kw = dict(B=8, inner_max=8)
    for o in (4, -1):
        with pytest.raises(ValueError, match="orientation"):
            t_ub.gs_round_oriented(x, K, x, x, o, **kw)
    with pytest.raises(ValueError, match="orientation"):
        t_ub.round_levels(2, 2, 4)
    with pytest.raises(ValueError, match="multiple"):
        t_ub.gs_round_oriented(x[:12], K[:12], x[:12], x[:12], 0, **kw)
    with pytest.raises(TypeError, match="uint8"):
        t_ub.gs_round_oriented(x, K.int(), x, x, 0, **kw)
    with pytest.raises(ValueError, match="prev has shape"):
        t_ub.gs_round_oriented(x, K, x, x, 0, prev=prev[:1], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        t_ub.gs_round_oriented(x.to("meta"), K, x, x, 0, **kw)
    # an orientation given as a tensor, as a round loop may keep it
    got, chg = t_ub.gs_round_oriented(x, K, x, x, torch.tensor(3), **kw)
    assert torch.equal(got, x) and not chg.any()


def test_probe_round_launches_only():
    """The sweep probe has no plain version: it refuses an unknown visit,
    then CPU tensors, before anything runs."""
    x = torch.ones((128, 128))
    W = torch.zeros((8, 128, 128))
    with pytest.raises(ValueError, match="visit must be one of"):
        t_ub.probe_round(x, W, x, B=128, inner_max=8, visit="barrier")
    for visit in t_ub.PROBE_VISITS:
        with pytest.raises(ValueError, match="unsupported device"):
            t_ub.probe_round(x, W, x, B=128, inner_max=8, visit=visit)
