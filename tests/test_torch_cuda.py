"""Checks of the CUDA UCA block kernels (K1 ``gs_round_oriented`` in the
TPU's Gauss-Seidel order, one dataflow launch a round, in every form; K2
``block_round``), the facet sweep kernel (``ops.facets``), the
union-find flood kernel (``ops.flood``), the device chain, the sharded
flood and the manager that need an NVIDIA GPU.

They skip without one.  The GPU machine has no JAX, so run them there
without the suite's conftest (which configures JAX):

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py
"""
import warnings

import numpy as np
import pytest
import torch

from chip_smoke import make_cone, make_hard_terrain, ring_window
from test_torch_flood import MASKS, flood_mask, flood_payload
from pydem_tpu_torch.api import DEMProcessor
from pydem_tpu_torch.core import slope_direction as sd
from pydem_tpu_torch.ops import uca_block as ub
from pydem_tpu_torch.parallel.sharded import terrain_pre
from pydem_tpu_torch.profiling import counters

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


N, M = 128, 192  # multiples of SHAPE_BLOCKS


def _state(device, n=N, m=M):
    """Receiver planes and base of a noisy quantized slope (float32), as the
    terrain step builds them."""
    rng = np.random.RandomState(11)
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, m)]
    elev = 2 - x - 0.5 * y ** 2 + rng.randn(n, m) * 0.01
    elev = torch.from_numpy(np.round(elev * 200) / 200).float().to(device)
    o1 = torch.ones(n - 1, dtype=elev.dtype, device=device)
    o = torch.ones(n, dtype=elev.dtype, device=device)
    _mag, _direction, _flats, W, base = terrain_pre(elev, o1, o1, o, o)
    return W, base.contiguous()


SHAPES = [(N, M), (192, 64)]  # non-square both ways
# the block sizes of KERNEL_BLOCKS checked on SHAPES and on 192x256 windows
SHAPE_BLOCKS = (16, 64)


def _shapes(B):
    """Non-square canvases of whole blocks, both ways: :data:`SHAPES` at
    :data:`SHAPE_BLOCKS`, 2B x 3B and 3B x B at the other block sizes."""
    return SHAPES if B in SHAPE_BLOCKS else [(2 * B, 3 * B), (3 * B, B)]


def _inner(B, inner_max):
    return 2 * B + 4 if inner_max is None else inner_max


@pytest.mark.parametrize("B,kernel", [
    (B, k) for B in ub.KERNEL_BLOCKS for k in ("K1 dataflow", "K2")])
@pytest.mark.parametrize("inner_max", [8, None])
def test_kernel_round_with_nan_equals_plain(cuda, B, kernel, inner_max):
    """NaNs in x inside one block travel downstream exactly as in the plain
    round (a strip that holds one never counts as settled), and the other
    blocks agree.  After 8 sweeps the wave is still inside the block (at
    B = 128 and 256 it crosses a cut between the cluster's bands)."""
    N, M = _shapes(B)[0]
    W, base = _state(cuda, N, M)
    x, _rounds = ub.accumulate_blocked_gs(base, W, B=B)
    x = x.clone()
    x[N // 2 + 1: N // 2 + 4, M // 2 + 3: M // 2 + 12] = float("nan")
    if B > 64:  # across the cut between two bands of one block
        x[B // 2 - 2: B // 2 + 2, 5: 9] = float("nan")
    kw = dict(B=B, inner_max=_inner(B, inner_max))
    if kernel == "K1 dataflow":
        K, W1 = ub.compact_from_dense(W)
        (xk, ck), (xp, cp) = (
            f(x, K, W1, base, 1, prev=None, **kw)
            for f in (ub.gs_round_oriented, ub.gs_round_oriented_plain))
    else:
        W = W.contiguous()
        (xk, ck), (xp, cp) = (fn(x, W, base, **kw)
                              for fn in (ub.block_round, ub.block_round_plain))
    if inner_max == 8:
        assert bool(torch.isnan(xp).any())
    assert torch.equal(torch.isnan(xk), torch.isnan(xp))
    assert torch.equal(torch.nan_to_num(xk), torch.nan_to_num(xp))
    assert torch.equal(ck, cp)


def test_kernel_solve_equals_plain_and_counts_launches(cuda):
    W, base = _state(cuda)
    before = ub.launch_count(ub.gs_round_oriented)
    reads = counters["solve_reads"]
    ak, rounds = ub.accumulate_blocked_gs(base, W, B=64)
    launches = ub.launch_count(ub.gs_round_oriented) - before
    # one dataflow launch a round; the flags are read once per 4 rounds, so
    # up to 3 still rounds follow
    assert rounds <= launches <= rounds + 3
    assert counters["solve_reads"] - reads == -(-rounds // 4)
    ap, rp = ub.accumulate_blocked_gs(base, W, B=64,
                                      round_fn=ub.gs_round_oriented_plain)
    assert ub.launch_count(ub.gs_round_oriented) - before == launches
    assert rp == rounds
    assert torch.equal(ak, ap)
    capped, r3 = ub.accumulate_blocked_gs(base, W, B=64, max_rounds=3)
    assert r3 == min(3, rounds)
    assert (ub.launch_count(ub.gs_round_oriented) - before
            == launches + r3)


def test_spans_on_the_card(cuda):
    """``terrain_step(blocked)`` under a recording on the card: CUDA-event
    spans a record, each under its parent, children inside their parent's
    time, one host read a batch of 4 rounds, outputs bitwise as without
    the recording."""
    from pydem_tpu_torch import profiling
    from pydem_tpu_torch.parallel.sharded import terrain_step

    elev = torch.from_numpy(make_hard_terrain(512, "float32")).to(cuda)
    o1 = torch.ones(511, dtype=elev.dtype, device=cuda)
    o = torch.ones(512, dtype=elev.dtype, device=cuda)
    plain = terrain_step(elev, o1, o1, o, o, uca_solver="blocked")
    with profiling.recording(cuda) as rec:
        traced = [terrain_step(elev, o1, o1, o, o, uca_solver="blocked")
                  for _ in range(2)]
    torch.cuda.synchronize()
    records = rec.records()
    assert len(records) == 2
    for r, out in zip(records, traced):
        assert r["parents"] == {
            "terrain_step": None, "pre": "terrain_step", "slopes": "pre",
            "flats": "pre", "label_flood": "flats", "section": "pre",
            "receivers": "pre", "pad": "terrain_step",
            "solve": "terrain_step", "compact": "solve",
            "post": "terrain_step"}
        ms = r["spans"]
        assert all(v >= 0 for v in ms.values())
        assert ms["pre"] + ms["pad"] + ms["solve"] + ms["post"] \
            <= ms["terrain_step"] * 1.001
        assert ms["slopes"] + ms["flats"] + ms["section"] \
            + ms["receivers"] <= ms["pre"] * 1.001
        assert ms["label_flood"] <= ms["flats"] * 1.001
        assert r["counters"]["solve_reads"] == -(-out["uca_sweeps"] // 4)
        # the flood is one union-find kernel call, three launches, and no
        # host-read sweep
        assert r["counters"]["flood_kernel"] == 1
        assert r["counters"]["flood_launches"] == 3
        assert r["counters"].get("flood_iters", 0) == 0
        for key in ("mag", "direction", "flats", "uca", "twi"):
            assert torch.equal(torch.nan_to_num(out[key]),
                               torch.nan_to_num(plain[key])), key


CLUSTER_BLOCKS = (128, 256)  # a visit on a thread-block cluster
MESH_BLOCKS = (8, 32)  # the shard B of the JAX mesh below 64


@pytest.mark.parametrize("B", ub.KERNEL_BLOCKS)
def test_cluster_sizes_are_resident(cuda, B):
    """A visit at B = 128 runs on a cluster of 4 CTAs, at 256 on 16, up to
    64 on one CTA; the card holds at least one cluster of each kernel (else
    the wrappers raise), and the dataflow grid is what it holds."""
    assert ub.kernel_cluster_size(B) == {8: 1, 16: 1, 32: 1, 64: 1, 128: 4,
                                         256: 16}[B]
    for kind, ring in (("dataflow", False), ("dataflow", True),
                       ("k2", False)):
        assert ub.resident_units(cuda, B, ring, kind) > 0


@pytest.mark.parametrize("B", CLUSTER_BLOCKS + MESH_BLOCKS)
@pytest.mark.parametrize("solver", ["gs", "pits_gs", "blocked", "pits"])
def test_cluster_solves_equal_plain(cuda, B, solver):
    """The four solvers at B = 128 and 256 (K1 in the TPU's order and K2,
    a cluster a block visit), and at the mesh's 32 and 8, against their
    plain rounds on the same card: equal rounds, the area bit for bit; the
    launches counted by block size."""
    n, m = 3 * B, 4 * B
    W, base = _state(cuda, n, m)
    links = _pit_links(cuda, n, m) if solver.startswith("pits") else ()
    name = ("accumulate_blocked" if solver == "blocked"
            else "accumulate_blocked_%s" % solver)
    fn = getattr(ub, name)
    k1 = solver.endswith("gs")
    wrapper = ub.gs_round_oriented if k1 else ub.block_round
    before = wrapper.launches_by_block[B]
    ak, rk = fn(base, W, *links, B=B)
    launches = wrapper.launches_by_block[B] - before
    assert rk <= launches <= rk + (3 if k1 else 0)
    plain = ub.gs_round_oriented_plain if k1 else ub.block_round_plain
    ap, rp = fn(base, W, *links, B=B, round_fn=plain)
    assert rk == rp
    assert torch.equal(ak, ap)


@pytest.mark.parametrize("B", CLUSTER_BLOCKS)
@pytest.mark.parametrize("kernel", ["dataflow", "dataflow ring", "K2"])
def test_cluster_round_repeats_bitwise(cuda, B, kernel):
    """The same round from the base 50 times: every canvas and flag plane
    bit for bit the first one, and that one the plain round's (a guard
    against a memory-order race between the cluster's bands or between
    dependent blocks)."""
    n = 4 * B
    W, base = _state(cuda, n, n)
    K, W1 = ub.compact_from_dense(W)
    kw = dict(B=B, inner_max=2 * B + 4)
    if kernel == "K2":
        W = W.contiguous()
        args, fn, plain = (base, W, base), ub.block_round, ub.block_round_plain
    elif kernel == "dataflow":
        args, fn, plain = ((base, K, W1, base, 1), ub.gs_round_oriented,
                           ub.gs_round_oriented_plain)
    else:
        n2 = n - 2 * B
        args = ring_window(base, K, W1, base, B // 2, B, n2, n2) + (2,)
        kw["ring"] = True
        fn, plain = ub.gs_round_oriented, ub.gs_round_oriented_plain
    want, want_chg = plain(*args, **kw)
    for _ in range(50):
        got, chg = fn(*args, **kw)
        assert torch.equal(got, want) and torch.equal(chg, want_chg)


@pytest.mark.parametrize("B", CLUSTER_BLOCKS)
@pytest.mark.parametrize("visit", ["async", "sweep"])
def test_probe_visits_equal_k2(cuda, B, visit):
    """The sweep probe's whole cluster visits (the kernels' own; the first
    one, a cluster barrier a sweep) equal K2's round bit for bit; the first
    one's cut variants run (their values are wrong by design)."""
    n = 2 * B
    W, base = _state(cuda, n, n)
    W = W.contiguous()
    kw = dict(B=B, inner_max=2 * B + 4)
    want, want_chg = ub.block_round(base, W, base, **kw)
    got, chg = ub.probe_round(base, W, base, visit=visit, **kw)
    assert torch.equal(got, want) and torch.equal(chg, want_chg)
    if visit == "sweep":
        for cut in ("_no_stores", "_cta_barrier"):
            ub.probe_round(base, W, base, visit=visit + cut, **kw)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,n", [(32, 192), (8, 80)])
@pytest.mark.parametrize("split", [True, False])
def test_mesh_at_shard_block_sizes_equals_plain(cuda, B, n, split):
    """A 2x2 mesh of four shards on the card whose shards take the JAX
    mesh's B = 32 (96²) or 8 (40²): the sharded solve through the dataflow
    kernel equals the same mesh through the plain rounds bit for bit, in
    equal rounds, the split and the serial round forced."""
    from pydem_tpu_torch.parallel import sharded
    from pydem_tpu_torch.parallel.mesh import make_mesh, split as cut

    W, base = _state(cuda, n, n)
    mesh = make_mesh([cuda] * 4, (2, 2))
    assert sharded._shard_block_size(n // 2, n // 2) == B
    outs = []
    for round_fn in (None, ub.gs_round_oriented_plain):
        before = ub.gs_round_oriented.launches_by_block[B]
        area, rounds = sharded._blocked_shards(
            cut(base, mesh), cut(W, mesh), mesh, B, _force_split=split,
            _round_fn=round_fn)
        launched = ub.gs_round_oriented.launches_by_block[B] - before
        outs.append((area, rounds, launched))
    (ak, rk, lk), (ap, rp, lp) = outs
    assert rk == rp > 1 and lk >= rk * 4 and lp == 0
    assert all(torch.equal(a, b) for a, b in zip(ak, ap))


@pytest.mark.parametrize("B,shape", [(B, s) for B in ub.KERNEL_BLOCKS
                                     for s in _shapes(B)])
@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("inner_max", [4, None])
def test_oriented_kernel_round_equals_plain(cuda, B, o, inner_max, shape):
    """The dataflow launch (at B = 128 and 256 a cluster a block) in the
    TPU's order against the plain round, bit for bit, flags included: a
    round from the base with every block relaxed, then two rounds at the
    next orientations with the frontier of the flags; one launch a round;
    the input canvas is not written."""
    n, m = shape
    W, base = _state(cuda, n, m)
    K, W1 = ub.compact_from_dense(W)
    kw = dict(B=B, inner_max=_inner(B, inner_max))
    x, prev = base, None
    for r in range(3):
        before = ub.launch_count(ub.gs_round_oriented)
        x_in = x.clone()
        xk, ck = ub.gs_round_oriented(x, K, W1, base, (o + r) % 4, prev=prev,
                                      **kw)
        assert ub.launch_count(ub.gs_round_oriented) - before == 1
        xp, cp = ub.gs_round_oriented_plain(x, K, W1, base, (o + r) % 4,
                                            prev=prev, **kw)
        assert torch.equal(x, x_in)
        assert torch.equal(xk, xp) and torch.equal(ck, cp)
        x, prev = xk, ck


@pytest.mark.parametrize("B", ub.KERNEL_BLOCKS)
@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("subset", ["all", "interior", "boundary"])
def test_oriented_ring_forms_equal_plain(cuda, B, o, subset):
    """The ring and subset forms in the TPU's order (a 192×256 window of a
    larger canvas, its ring real, at :data:`SHAPE_BLOCKS`; 3B x 4B at the
    other block sizes), the dataflow launch against the plain round, bit
    for bit, flags included, in place; the ring is never written; then,
    from that canvas, a round on the frontier of its flags."""
    rows, cols = (192, 256) if B in SHAPE_BLOCKS else (3 * B, 4 * B)
    W, base = _state(cuda, rows + 64, cols + 64)
    K, W1 = ub.compact_from_dense(W)
    args = ring_window(base * 1.5, K, W1, base, 32, 48, rows, cols)
    ring = torch.ones_like(args[0], dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    kw = dict(B=B, inner_max=2 * B + 4, ring=True, subset=subset)
    prev = None
    for r in range(2):
        xp, cp = ub.gs_round_oriented_plain(*args, (o + r) % 4, prev=prev,
                                            **kw)
        x = args[0].clone()
        xk, ck = ub.gs_round_oriented(x, *args[1:], (o + r) % 4, prev=prev,
                                      inplace=True, **kw)
        assert xk is x
        assert torch.equal(xk, xp) and torch.equal(ck, cp)
        assert torch.equal(xk[ring], args[0][ring])
        args, prev = (xk,) + args[1:], ck


@pytest.mark.parametrize("B", [16, 256])
def test_dataflow_rounds_on_streams_keep_their_own_tickets(cuda, B):
    """Rounds on two streams at once (the split round's shards) draw their
    tickets from two counters, and many rounds on one stream reuse one
    without a reset: forty rounds over four streams equal the plain rounds
    bit for bit (at B = 256 four launches of 16-CTA clusters share the
    card)."""
    W, base = _state(cuda, *_shapes(B)[0])
    K, W1 = ub.compact_from_dense(W)
    kw = dict(B=B, inner_max=2 * B + 4)
    want, x = [], []
    for k in range(4):
        xp = base * (1 + k)
        for r in range(10):
            xp, _c = ub.gs_round_oriented_plain(xp, K, W1, base, r % 4, **kw)
        want.append(xp)
        x.append((base * (1 + k)).contiguous())
    streams = [torch.cuda.Stream(cuda) for _ in range(4)]
    torch.cuda.synchronize(cuda)
    for r in range(10):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                ub.gs_round_oriented(x[k], K, W1, base, r % 4, inplace=True,
                                     **kw)
    torch.cuda.synchronize(cuda)
    for a, b in zip(x, want):
        assert torch.equal(a, b)


def test_kernel_wrapper_rejects_what_it_cannot_run(cuda):
    x = torch.ones((64, 64), device=cuda)
    K = torch.full((64, 64), 255, dtype=torch.uint8, device=cuda)
    kw = dict(B=64, inner_max=8)
    with pytest.raises(TypeError, match="float32"):
        ub.gs_round_oriented(x.double(), K, x.double(), x.double(), 0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ub.gs_round_oriented(x.t(), K, x, x, 0, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        ub.gs_round_oriented(x, K.cpu(), x, x, 0, **kw)
    with pytest.raises(ValueError, match="built for"):
        ub.gs_round_oriented(x, K, x, x, 0, B=4, inner_max=8)
    with pytest.raises(ValueError, match="orientation"):
        ub.gs_round_oriented(x, K, x, x, 4, **kw)


@pytest.mark.parametrize("B,shape", [(B, s) for B in ub.KERNEL_BLOCKS
                                     for s in _shapes(B)])
@pytest.mark.parametrize("planes", ["terrain", "dense random"])
@pytest.mark.parametrize("inner_max", [4, 6, 8, None])
def test_k2_round_equals_plain(cuda, B, planes, inner_max, shape):
    """K2 == its plain round bitwise, also on dense planes with 3+ outgoing
    weights per pixel (which the compact encoding cannot hold)."""
    n, m = shape
    W, base = _state(cuda, n, m)
    W = W.contiguous()
    if planes == "dense random":
        rng = np.random.RandomState(B)
        W = torch.from_numpy(rng.uniform(0, 0.12, (8, n, m))
                             .astype(np.float32)).to(cuda)
    inner = _inner(B, inner_max)
    x = base
    for _ in range(3):
        xk, ck = ub.block_round(x, W, base, B=B, inner_max=inner)
        xp, cp = ub.block_round_plain(x, W, base, B=B, inner_max=inner)
        assert torch.equal(xk, xp)
        assert torch.equal(ck, cp)
        x = xk


def _pit_links(device, n=N, m=M, count=300, seed=5):
    """Random pit links, ten into each destination (the fold must still be
    deterministic).  Each link drops 5-14 rows down the slope of
    :func:`_state`, so the drainage graph stays acyclic."""
    rng = np.random.RandomState(seed)
    dst_i = rng.randint(20, n, count // 10).repeat(10)
    dst = dst_i * m + rng.randint(0, m, count // 10).repeat(10)
    src = (dst_i - rng.randint(5, 15, count)) * m + rng.randint(0, m, count)
    w = rng.uniform(0, 0.5, count).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (src, dst, w))


def test_k1_with_fold_solve_equals_plain(cuda):
    W, base = _state(cuda)
    links = _pit_links(cuda)
    before = ub.launch_count(ub.gs_round_oriented)
    ak, rk = ub.accumulate_blocked_pits_gs(base, W, *links, B=64)
    launches = ub.launch_count(ub.gs_round_oriented) - before
    assert rk <= launches <= rk + 3
    ap, rp = ub.accumulate_blocked_pits_gs(
        base, W, *links, B=64, round_fn=ub.gs_round_oriented_plain)
    assert rp == rk
    assert torch.equal(ak, ap)
    again, _ = ub.accumulate_blocked_pits_gs(base, W, *links, B=64)
    assert torch.equal(again, ak)


def test_k2_with_pits_solve_equals_plain(cuda):
    W, base = _state(cuda)
    links = _pit_links(cuda)
    before = ub.launch_count(ub.block_round)
    ak, rk = ub.accumulate_blocked_pits(base, W, *links, B=16)
    assert ub.launch_count(ub.block_round) - before == rk
    ap, rp = ub.accumulate_blocked_pits(base, W, *links, B=16,
                                        round_fn=ub.block_round_plain)
    assert rp == rk
    assert torch.equal(ak, ap)


def test_demprocessor_blocked_matches_jacobi(cuda):
    """The device chain on a 256² hard terrain: blocked (K1 with the pit
    fold) within the JAX bench gate of jacobi, and bit for bit repeatable."""
    elev = make_hard_terrain(256)
    # no ``device``: the processor's default is the card
    kw = dict(conditioning_backend="device", pit_backend="device")
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for solver in ("blocked", "jacobi", "blocked"):
            before = ub.launch_count(ub.gs_round_oriented)
            dp = DEMProcessor(elev=elev.copy(), uca_solver=solver, **kw)
            assert dp.device.type == "cuda"
            dp.calc_twi()
            if solver == "blocked":
                assert ub.launch_count(ub.gs_round_oriented) > before
            runs.setdefault(solver, []).append(dp.uca)
    b, j = runs["blocked"][0], runs["jacobi"][0]
    np.testing.assert_array_equal(np.isnan(b), np.isnan(j))
    np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(j), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_array_equal(runs["blocked"][1], b)


def test_reachability_and_update_on_the_card_equal_the_cpu(cuda):
    """The flood (with pit hops into shared destinations) and the delta
    propagation give the CPU's result on the card: the flood exactly and
    twice alike, the delta in float64 to relative 1e-12."""
    from pydem_tpu_torch.core.uca import accumulate_update, reachability

    W, _base = _state("cpu")
    W = W.double()
    n, m = W.shape[1:]
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.choice(n * m, 400, replace=False))
    dst = torch.from_numpy(rng.randint(0, 50, 400) * 97)  # many collisions
    w = torch.from_numpy((rng.uniform(size=400) > 0.3) * rng.uniform(
        0.1, 1.0, 400))
    seed = torch.zeros((n, m), dtype=torch.bool)
    seed.reshape(-1)[src[:40]] = True
    want = reachability(seed, W, src, dst, w)
    to = lambda t: t.to(cuda)  # noqa: E731
    for _ in range(2):
        got = reachability(to(seed), to(W), to(src), to(dst), to(w))
        assert torch.equal(got.cpu(), want)

    delta0 = torch.zeros((n, m), dtype=torch.float64)
    delta0[:, 0] = torch.from_numpy(rng.uniform(0, 5, n))
    receive = torch.ones((n, m), dtype=torch.float64)
    receive[0, :] = 0
    links = (src[:60], dst[:60] + torch.arange(60) * 3, w[:60] * 0.5)
    want_d, want_n = accumulate_update(delta0, W, receive, None, *links)
    got_d, got_n = accumulate_update(to(delta0), to(W), to(receive), None,
                                     *(to(t) for t in links))
    assert got_n == want_n
    np.testing.assert_allclose(got_d.cpu().numpy(), want_d.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_manager_on_the_card_by_default(cuda, tmp_path):
    """``ProcessManager`` without ``device``: the processor's tensors are on
    the card, K1 runs for a 256² mosaic with the default (host) backends,
    and the CLI's default device works."""
    from chip_smoke import make_noisy_cone, write_tiles
    from pydem_tpu_torch import cli
    from pydem_tpu_torch.manager import ProcessManager

    tiles = str(tmp_path / "tiles")
    assert write_tiles(make_noisy_cone(256), tiles) == 4
    ub.gs_round_oriented.launches_on.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = ProcessManager(in_path=tiles)
        twi = pm.process_twi()
    assert pm._dp.device.type == "cuda" and pm.device.type == "cuda"
    assert ub.launch_count(ub.gs_round_oriented) > 0
    assert twi.shape == (256, 256) and pm.out_file["success"].all()
    assert pm.out_file["edge_done"].dtype == bool
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.process([tiles, "--store", str(tmp_path / "cli.zarr"), "--out",
                     str(tmp_path / "out")])
    from pydem_tpu_torch.io import read_geotiff

    got = read_geotiff(str(tmp_path / "out" / "uca.tif")).data
    ref = pm.out_file["uca"].astype("float32")
    np.testing.assert_array_equal(got, np.where(np.isnan(ref),
                                                np.float32(-9999), ref))


def test_out_of_core_engine_on_the_card(cuda, tmp_path):
    """``OutOfCoreEngine`` without ``device`` at 512², S = 128 (B = 128, a
    cluster of 4 CTAs a block), on the noisy cone: both regimes launch K1
    in the TPU's order (the streamed visits its ring form, the fused pass
    its canvas form); ``elev``, ``slope``, ``aspect``, ``flats`` and the NaN patterns agree bitwise, ``uca`` within
    the bench gate (bitwise where the terrain has no pit links)."""
    from chip_smoke import make_noisy_cone
    from pydem_tpu_torch.io.store import ArrayStore
    from pydem_tpu_torch.outofcore import OutOfCoreEngine

    n, S = 512, 128
    elev = make_noisy_cone(n).astype("float64")
    stores = {}
    for tag, budget in (("streamed", 0), ("fused", None)):
        store = ArrayStore(str(tmp_path / (tag + ".zarr")))
        store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                     fill=np.nan, overwrite=True)
        store.write_window("elev_src", elev, (0, 0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = OutOfCoreEngine(store, elev.shape, np.ones(n - 1),
                                  np.ones(n - 1), np.ones(n), np.ones(n),
                                  superblock=S, device_cache_bytes=budget)
            # the JAX engine's block size on a TPU: 128 under 256
            assert eng.device.type == "cuda" and eng.B == 128
            assert eng._work_dtype == "float32"
            assert eng._fits_device_resident() == (budget is None)
            ub.gs_round_oriented.launches_on.clear()
            eng.run()
        assert ub.launch_count(ub.gs_round_oriented) > 0
        assert (eng.uca_visits > 0) == (budget == 0)
        stores[tag] = (store, eng)
    (a, ea), (b, eb) = stores["streamed"], stores["fused"]
    for key in ("elev", "slope", "aspect", "flats"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in ("uca", "twi"):
        assert a[key].dtype == np.float32
        np.testing.assert_array_equal(np.isnan(a[key]), np.isnan(b[key]))
        if len(ea._links[0]) == 0:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_allclose(np.nan_to_num(a["uca"]),
                               np.nan_to_num(b["uca"]), rtol=1e-4, atol=1e-2)


def _near_step(got, step):
    """A mesh run against one device's ``terrain_step(blocked)`` (the TPU's
    Gauss-Seidel order on the whole canvas; each shard runs its own grid):
    the same NaN pattern and fixed point within the JAX bench gate."""
    a, b = got["uca"].numpy(), step["uca"].cpu().numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=1e-4,
                               atol=1e-2)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_sharded_equals_single_device_on_the_card(cuda, shape):
    """``run_sharded(uca_solver="blocked")`` over shards on ``cuda:0`` at
    2048² (B = 256): within the bench gate of one device's
    ``terrain_step(blocked)``, which a 1×1 mesh equals bitwise with equal
    rounds; the solver takes the split round where the shards hold at
    least 3×3 blocks (1×2: 8×4, 2×2: 4×4; 2×4 has 4×2), two dataflow
    launches a shard a round; at 512² and B = 64 the split and the serial
    round, both forced, and the solve with pit links equal the same mesh
    through the plain rounds bitwise, rounds equal."""
    from pydem_tpu_torch.parallel import sharded
    from pydem_tpu_torch.parallel.mesh import assemble, make_mesh, split
    from pydem_tpu_torch.parallel.sharded import run_sharded, terrain_step

    n = 2048  # the default B = 256: shards of 8x4, 4x4 and 4x2 blocks
    mesh = make_mesh([cuda] * (shape[0] * shape[1]), shape)
    one = make_mesh([cuda], (1, 1))
    elev = torch.from_numpy(make_hard_terrain(n, "float32")).to(cuda)
    rows = (torch.ones(n - 1, device=cuda),) * 2 + (
        torch.ones(n, device=cuda),) * 2
    step = terrain_step(elev, *rows, uca_solver="blocked")
    single = run_sharded(elev, *rows, mesh=one, uca_solver="blocked")
    assert single["uca_sweeps"] == step["uca_sweeps"]
    for key in ("mag", "direction", "flats", "uca", "twi"):
        assert torch.equal(torch.nan_to_num(single[key].assemble().double()),
                           torch.nan_to_num(step[key].double())), key
    splits = shape != (2, 4)
    before = ub.launch_count(ub.gs_round_oriented)
    out = run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")
    launches = ub.launch_count(ub.gs_round_oriented) - before
    assert launches >= (2 if splits else 1) * mesh.size * out["uca_sweeps"]
    assert sharded._blocked_shards.last_split == splits
    _near_step({"uca": out["uca"].assemble().cpu()}, step)
    n = 512
    W, base = _state(cuda, n, n)
    links = _pit_links(cuda, n, n)
    for force, lk in ((True, None), (False, None), (None, links)):
        if force and not splits:
            continue
        runs = [sharded._blocked_shards(
            split(base, mesh), split(W, mesh), mesh, 64,
            links=sharded._links_of(lk, mesh, n // shape[0], n // shape[1],
                                    base.dtype),
            _force_split=force, _round_fn=fn)
            for fn in (None, ub.gs_round_oriented_plain)]
        (a_k, r_k), (a_p, r_p) = runs
        assert r_k == r_p and torch.equal(assemble(a_k, mesh),
                                          assemble(a_p, mesh))


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    return [torch.device("cuda", k) for k in range(4)]


@pytest.mark.parametrize("force", [None, True, False])
def test_sharded_over_four_cards_equals_one_card(four_cards, force):
    """A 2x2 mesh with one shard a card at 512²: the sharded K1 solve (the
    solver's round, the serial one over several cards, and the split and
    the serial round forced) bitwise equal to the same round over four
    shards on one card, rounds equal, with and without pit links; every
    card launched the dataflow kernel; unforced, the whole ``run_sharded``
    within the bench gate of one card's ``terrain_step(blocked)``."""
    from pydem_tpu_torch.parallel import sharded
    from pydem_tpu_torch.parallel.mesh import assemble, make_mesh, split
    from pydem_tpu_torch.parallel.sharded import run_sharded, terrain_step

    n, dev0 = 512, four_cards[0]
    mesh = make_mesh(four_cards, (2, 2))
    on_one = make_mesh([dev0] * 4, (2, 2))
    elev = torch.from_numpy(make_hard_terrain(n, "float32")).to(dev0)
    rows = (torch.ones(n - 1, device=dev0),) * 2 + (
        torch.ones(n, device=dev0),) * 2
    if force is None:
        out = run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")
        _near_step({"uca": out["uca"].assemble().cpu()},
                   terrain_step(elev, *rows, uca_solver="blocked"))
    W, base = _state(dev0, n, n)
    links = _pit_links(dev0, n, n)
    for lk in (None, links):
        ub.gs_round_oriented.launches_on.clear()
        area, rounds = sharded._blocked_shards(
            split(base, mesh), split(W, mesh), mesh, 64,
            links=sharded._links_of(lk, mesh, n // 2, n // 2, base.dtype),
            _force_split=force)
        split_ = sharded._blocked_shards.last_split
        assert split_ == bool(force)
        assert all(ub.gs_round_oriented.launches_on[d] > 0
                   for d in four_cards)
        want, rw = sharded._blocked_shards(
            split(base, on_one), split(W, on_one), on_one, 64,
            links=sharded._links_of(lk, on_one, n // 2, n // 2, base.dtype),
            _force_split=split_)
        assert rounds == rw and torch.equal(
            assemble(area, mesh, device=dev0), assemble(want, on_one))


def test_sharded_outputs_stay_on_their_cards(four_cards):
    """run_sharded over a 2x2 mesh of the four cards, its canvas given from
    the host: every output shard lies on its cell's card, and the host
    copies of mag, direction and flats equal one card's terrain_step
    bitwise, uca within the bench gate."""
    from pydem_tpu_torch.parallel.mesh import ShardedCanvas, make_mesh
    from pydem_tpu_torch.parallel.sharded import run_sharded, terrain_step

    n = 1024
    mesh = make_mesh(four_cards, (2, 2))
    elev = make_hard_terrain(n, "float32")
    rows = (np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n))
    out = run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")
    dev0 = four_cards[0]
    t_rows = [torch.as_tensor(r, dtype=torch.float32, device=dev0)
              for r in rows]
    step = terrain_step(torch.from_numpy(elev).to(dev0), *t_rows,
                        uca_solver="blocked")
    for key in ("mag", "direction", "flats", "uca", "twi"):
        c = out[key]
        assert isinstance(c, ShardedCanvas) and c.shape == (n, n), key
        for cell, s in zip(mesh.local_shards(), c.local_shards()):
            assert s.device == mesh.devices[cell], (key, cell, s.device)
        if key in ("mag", "direction", "flats"):
            a, b = np.asarray(c), step[key].cpu().numpy()
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), key
    _near_step({"uca": out["uca"].assemble().cpu()}, step)


def test_first_card_holds_no_more_than_the_others(four_cards):
    """With the canvas given from the host, no card stages the whole
    canvas or another card's outputs: after a run, cuda:0's peak is within
    10% of the largest of the other cards'."""
    import gc

    from pydem_tpu_torch.parallel.mesh import make_mesh
    from pydem_tpu_torch.parallel.sharded import run_sharded

    n = 2048
    mesh = make_mesh(four_cards, (2, 2))
    elev = make_cone(n)  # the four shards mirror each other
    rows = (np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n))
    run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")  # warm-up
    gc.collect()
    for d in four_cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    held = {d: torch.cuda.memory_allocated(d) for d in four_cards}
    out = run_sharded(elev, *rows, mesh=mesh, uca_solver="blocked")
    for d in four_cards:
        torch.cuda.synchronize(d)
    peak = {d: torch.cuda.max_memory_allocated(d) - held[d]
            for d in four_cards}
    others = max(peak[d] for d in four_cards[1:])
    assert peak[four_cards[0]] <= 1.10 * others, peak
    del out


def test_engine_over_four_cards_equals_one_card(four_cards, tmp_path,
                                               monkeypatch):
    """The out-of-core engine's fused pass with its canvases per shard on a
    2x2 mesh of four cards equals the same mesh on one card, bitwise, the
    one card held to the four cards' serial round (its own would split,
    another order)."""
    from pydem_tpu_torch.parallel import sharded
    from pydem_tpu_torch.io.store import ArrayStore
    from pydem_tpu_torch.outofcore import OutOfCoreEngine
    from pydem_tpu_torch.parallel.mesh import make_mesh

    n, S = 256, 128  # the engine's block size on a card divides S
    elev = make_hard_terrain(n)
    stores = []
    monkeypatch.setattr(sharded, "_use_split",
                        lambda mesh, nb, force=None: False)
    for tag, cells in (("one", [four_cards[0]] * 4), ("four", four_cards)):
        store = ArrayStore(str(tmp_path / tag))
        store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                     fill=np.nan, overwrite=True)
        store.write_window("elev_src", elev, (0, 0))
        eng = OutOfCoreEngine(store, elev.shape, np.ones(n - 1),
                              np.ones(n - 1), np.ones(n), np.ones(n),
                              superblock=S, mesh=make_mesh(cells, (2, 2)))
        assert eng._fits_device_resident()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng.run()
        stores.append((store, eng.uca_rounds))
    (a, ra), (b, rb) = stores
    assert ra == rb
    for key in ("slope", "aspect", "flats", "uca", "twi"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# -- the facet sweep kernel (ops/csrc/facets.cu) -----------------------------

def _fbm(n, m, seed=7, hurst=0.8):
    """An fBm surface in whole metres (600 m of relief): rounding leaves
    exact ties between neighbours, and a quarter of it is one plateau."""
    rng = np.random.RandomState(seed)
    k = np.hypot(np.fft.fftfreq(n)[:, None], np.fft.rfftfreq(m)[None, :])
    k[0, 0] = 1.0
    amp = k ** -(hurst + 1.0)
    amp[0, 0] = 0.0
    z = np.fft.irfft2(amp * (rng.randn(*amp.shape)
                             + 1j * rng.randn(*amp.shape)), s=(n, m))
    z = np.round((z - z.min()) / max(np.ptp(z), 1e-12) * 600.0)
    z[n // 4: n // 2, m // 4: m // 2] = z[n // 4, m // 4]
    return z


def _facet_surface(kind, n, m):
    if kind == "cone":
        x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, m)]
        return 1 - np.sqrt(x ** 2 + y ** 2) / np.sqrt(2.0)
    z = _fbm(n, m)
    if kind == "fbm sea":
        z[n // 2:, :] = np.nan
    return z


def _spacing(kind, n, dtype, device):
    """Scalars, or per-row spacings as on a geographic grid (the columns
    narrow with latitude)."""
    if kind == "scalar":
        return 30.0, 25.0
    rows = np.arange(n - 1)
    dX = 92.6 * np.cos(np.radians(40.0 + rows * 5.0 / max(n, 2)))
    dY = 92.6 + 0.001 * rows
    return (torch.tensor(dX, dtype=dtype, device=device),
            torch.tensor(dY, dtype=dtype, device=device))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _sweeps_equal(elev, dX, dY):
    """The kernel's sweep (through ``slopes_directions``) and the eager
    sweep of the same card tensors, bit for bit; one kernel call, two
    launches."""
    before = counters["facet_kernel"], counters["facet_launches"]
    mag, direction = sd.slopes_directions(elev, dX, dY)
    assert (counters["facet_kernel"] - before[0],
            counters["facet_launches"] - before[1]) == (1, 2)
    want_mag, want_dir = sd._slopes_directions_eager(elev, dX, dY)
    torch.cuda.synchronize()
    assert mag.is_contiguous() and mag.shape == elev.shape
    assert torch.equal(_bits(mag), _bits(want_mag)), int(
        (_bits(mag) != _bits(want_mag)).sum())
    assert torch.equal(_bits(direction), _bits(want_dir)), int(
        (_bits(direction) != _bits(want_dir)).sum())


@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (5, 2), (3, 3),
                                   (257, 263)])
@pytest.mark.parametrize("surface", ["fbm", "fbm sea", "cone"])
@pytest.mark.parametrize("spacing", ["scalar", "per row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_facet_kernel_equals_eager(cuda, shape, surface, spacing, dtype):
    n, m = shape
    elev = torch.tensor(_facet_surface(surface, n, m), dtype=dtype,
                        device=cuda)
    _sweeps_equal(elev, *_spacing(spacing, n, dtype, cuda))


def test_facet_kernel_equals_eager_on_a_tile(cuda):
    """One 6000² float32 tile, half sea, geographic spacings: the
    benchmark's shape."""
    n = 6000
    elev = torch.tensor(_facet_surface("fbm sea", n, n), dtype=torch.float32,
                        device=cuda)
    _sweeps_equal(elev, *_spacing("per row", n, torch.float32, cuda))


@pytest.mark.parametrize("view", ["columns", "transposed"])
def test_facet_kernel_on_a_view(cuda, view):
    """A non-contiguous ``elev`` (a window's columns, a transpose)."""
    big = torch.tensor(_facet_surface("fbm", 70, 76), dtype=torch.float32,
                       device=cuda)
    elev = big[:, 3:-3] if view == "columns" else big.t()
    assert not elev.is_contiguous()
    _sweeps_equal(elev, *_spacing("per row", elev.shape[0], elev.dtype,
                                  cuda))


def test_terrain_pre_with_the_facet_kernel(cuda, monkeypatch):
    """``terrain_pre``'s five outputs on the card equal those built from
    the eager sweep, and the kernel ran once."""
    from pydem_tpu_torch.parallel import sharded

    n, m = 300, 280
    elev = torch.tensor(_facet_surface("fbm sea", n, m), dtype=torch.float32,
                        device=cuda)
    dX, dY = _spacing("per row", n, elev.dtype, cuda)
    rows = torch.full((n,), 92.6, dtype=elev.dtype, device=cuda)
    before = counters["facet_kernel"]
    got = terrain_pre(elev, dX, dY, rows * 0.8, rows)
    assert counters["facet_kernel"] - before == 1
    monkeypatch.setattr(sharded, "slopes_directions",
                        sd._slopes_directions_eager)
    want = terrain_pre(elev, dX, dY, rows * 0.8, rows)
    assert counters["facet_kernel"] - before == 1
    for name, a, b in zip(("mag", "direction", "flats", "W", "base"), got,
                          want):
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            assert torch.equal(_bits(a), _bits(b)), name


# -- the union-find flood kernel (ops/csrc/flood.cu) -------------------------

def _floods_equal(mask, payload):
    """``label_flood`` through the kernel and the eager loop on the same
    card tensors: labels and ``rep`` bit for bit; one kernel call, three
    launches (none on an empty canvas), no host-read sweep."""
    keys = ("flood_kernel", "flood_launches", "flood_iters")
    before = [counters[k] for k in keys]
    lbl, rep = sd.label_flood(mask, payload)
    launches = 3 if mask.numel() else 0
    assert [counters[k] - b for k, b in zip(keys, before)] == [1, launches,
                                                               0]
    want_lbl, want_rep = sd._label_flood_eager(mask, payload)
    torch.cuda.synchronize()
    assert lbl.dtype == torch.int32 and lbl.shape == mask.shape
    assert torch.equal(lbl, want_lbl), int((lbl != want_lbl).sum())
    assert torch.equal(_bits(rep), _bits(want_rep))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", [(1, 1), (1, 77), (77, 1), (33, 65),
                                   (257, 263), (1000, 1501)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flood_kernel_equals_eager(cuda, kind, shape, dtype):
    """Every mask of the CPU tests on thin canvases, shapes that are no
    multiple of the kernel's 32 x 32 tile, and ~1.5 Mpx."""
    n, m = shape
    mask = torch.from_numpy(flood_mask(kind, n, m)).to(cuda)
    _floods_equal(mask, flood_payload(n, m, dtype).to(cuda))


@pytest.mark.parametrize("shape", [(0, 5), (5, 0)])
def test_flood_kernel_on_an_empty_canvas(cuda, shape):
    _floods_equal(torch.zeros(shape, dtype=torch.bool, device=cuda),
                  torch.zeros(shape, device=cuda))


@pytest.mark.parametrize("kind", ["sea", "random 0.45"])
def test_flood_kernel_equals_eager_on_a_tile(cuda, kind):
    """A 6000² coast-like mask (the lower half of an fBm surface: one sea,
    islands and bays) and a random one at the percolation threshold."""
    n = 6000
    mask = torch.from_numpy(flood_mask(kind, n, n, seed=5)).to(cuda)
    _floods_equal(mask, flood_payload(n, n, torch.float32).to(cuda))


@pytest.mark.parametrize("view", ["columns", "transposed"])
def test_flood_kernel_on_a_view(cuda, view):
    """A non-contiguous mask (a window's columns, a transpose)."""
    big = torch.from_numpy(flood_mask("sea", 90, 130)).to(cuda)
    mask = big[:, 3:-3] if view == "columns" else big.t()
    assert not mask.is_contiguous()
    n, m = mask.shape
    _floods_equal(mask, flood_payload(n, m, torch.float32).to(cuda))


def test_flood_kernel_repeats_bitwise(cuda):
    """The atomics run in another order every call; the labels are the
    same integers every time."""
    mask = torch.from_numpy(flood_mask("random 0.45", 2000, 2000)).to(cuda)
    first = sd.label_flood(mask, mask.float())[0]
    for _ in range(20):
        assert torch.equal(sd.label_flood(mask, mask.float())[0], first)


def test_find_flats_edges_and_terrain_pre_with_the_flood_kernel(
        cuda, monkeypatch):
    """``find_flats_edges`` and ``terrain_pre``'s five outputs on the card
    equal those built from the eager flood, on a tile with a sea and
    plateaus; the kernel ran once a call."""
    n, m = 300, 280
    elev = torch.tensor(_facet_surface("fbm sea", n, m), dtype=torch.float32,
                        device=cuda)
    dX, dY = _spacing("per row", n, elev.dtype, cuda)
    rows = torch.full((n,), 92.6, dtype=elev.dtype, device=cuda)
    mag, _direction = sd.slopes_directions(elev, dX, dY)
    before = counters["flood_kernel"]
    edges = sd.find_flats_edges(elev, mag)
    got = terrain_pre(elev, dX, dY, rows * 0.8, rows)
    assert counters["flood_kernel"] - before == 2
    assert (mag == sd.FLAT_ID_INT).sum() > n * m // 3
    monkeypatch.setattr(sd, "label_flood", sd._label_flood_eager)
    assert torch.equal(edges, sd.find_flats_edges(elev, mag))
    want = terrain_pre(elev, dX, dY, rows * 0.8, rows)
    assert counters["flood_kernel"] - before == 2
    for name, a, b in zip(("mag", "direction", "flats", "W", "base"), got,
                          want):
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("grid", [(2, 2), (1, 3)])
def test_label_flood_sharded_on_one_card(cuda, grid):
    """``label_flood_sharded`` over shards on one card (each shard's local
    components through the kernel) gives the one-card labels and reps."""
    from pydem_tpu_torch.parallel.mesh import make_mesh
    from pydem_tpu_torch.parallel.sharded import label_flood_sharded

    n, m = 240, 360
    mask = torch.from_numpy(flood_mask("sea", n, m, seed=2)).to(cuda)
    payload = flood_payload(n, m, torch.float32).to(cuda)
    lbl, rep = sd.label_flood(mask, payload)
    mesh = make_mesh([cuda] * (grid[0] * grid[1]), grid)
    before = counters["flood_kernel"]
    lbl_s, rep_s = label_flood_sharded(mask, payload, mesh)
    assert counters["flood_kernel"] - before == grid[0] * grid[1]
    assert torch.equal(lbl_s.assemble(), lbl)
    assert torch.equal(_bits(rep_s.assemble()), _bits(rep))


def test_label_flood_sharded_over_four_cards(four_cards):
    """``label_flood_sharded`` over a 2x2 mesh with a shard a card: the
    kernel runs on each card, and the labels and reps equal one card's
    ``label_flood``."""
    from pydem_tpu_torch.parallel.mesh import make_mesh
    from pydem_tpu_torch.parallel.sharded import label_flood_sharded

    n, m, dev0 = 480, 640, four_cards[0]
    mask = torch.from_numpy(flood_mask("sea", n, m, seed=3)).to(dev0)
    payload = flood_payload(n, m, torch.float32).to(dev0)
    lbl, rep = sd.label_flood(mask, payload)
    before = counters["flood_kernel"]
    lbl_s, rep_s = label_flood_sharded(mask, payload,
                                       make_mesh(four_cards, (2, 2)))
    assert counters["flood_kernel"] - before == 4
    assert sorted(s.device.index for s in lbl_s.local_shards()) == [0, 1, 2,
                                                                    3]
    assert torch.equal(lbl_s.assemble().to(dev0), lbl)
    assert torch.equal(_bits(rep_s.assemble().to(dev0)), _bits(rep))
