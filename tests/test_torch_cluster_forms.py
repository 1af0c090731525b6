"""K1's forms in the TPU's Gauss-Seidel order at the TPU's B = 128, and at
the mesh's B = 32 and 8, on the CPU, float64, against the JAX package's
``gs_round_oriented`` (Pallas in interpret mode): the canvas, ring,
interior and frame rounds at every orientation, from a canvas on its way
with every block dirty, and at the next orientation on a sparse frontier.

On the card the rounds at B = 128 run on a thread-block cluster of 4 CTAs
a block, those at 32 and 8 on one CTA a block; the plain version held here
is what the kernels equal bit for bit (``chip_smoke.py`` phase 3,
``tests/test_torch_cuda.py``).

Tolerances: flags exact (the frame's through the walk), values to 10
decimals (the JAX kernel's interpret-mode sums round differently in the last
bits on the CPU, ``tests/test_torch_oriented.py``); the ring untouched.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydem_tpu.ops import uca_block as j_ub
from pydem_tpu_torch.ops import uca_block as t_ub
from test_torch_oriented import _jax_flags, _jax_padded, _region

torch.set_num_threads(1)

B, N = 128, 384  # a 3x3 block grid, the least a subset round takes
HR, HC = j_ub.HR, j_ub.HC


def _case(form, seed, N=N):
    """The ringed region of a form (the canvas form's ring reads as the
    zero pad of a canvas) and the subset it runs."""
    xr, Kr, W1r, base = _region(seed, N, N)
    if form == "canvas":
        ring = np.ones(xr.shape, bool)
        ring[1:-1, 1:-1] = False
        xr[ring], Kr[ring], W1r[ring] = 0.0, 255, 0.0
    return xr, Kr, W1r, base, "all" if form in ("canvas", "ring") else form


def _jax_round(xr, Kr, W1r, base, o, subset, prev, B=B):
    N = base.shape[0]
    xp, kp, wp = _jax_padded(xr, Kr, W1r)
    jx, jchg = j_ub.gs_round_oriented(
        xp, kp, wp, jnp.asarray(base), o, B=B, inner_max=2 * B + 4,
        interpret=True, subset=subset,
        prev=None if prev is None else jnp.asarray(prev))
    seq = t_ub.visit_sequence(N // B, N // B, o, subset)
    return (np.asarray(jx)[HR - 1: HR + N + 1, HC - 1: HC + N + 1],
            _jax_flags(jchg, subset, seq, (N // B, N // B)))


def _port_round(form, xr, Kr, W1r, base, o, subset, prev, B=B):
    kw = dict(B=B, inner_max=2 * B + 4, subset=subset,
              prev=None if prev is None else torch.from_numpy(prev))
    if form == "canvas":
        got, chg = t_ub.gs_round_oriented(
            *(torch.from_numpy(a[1:-1, 1:-1].copy()) for a in (xr, Kr, W1r)),
            torch.from_numpy(base), o, **kw)
        return np.pad(got.numpy(), 1), chg.numpy()
    got, chg = t_ub.gs_round_oriented(
        *(torch.from_numpy(a) for a in (xr, Kr, W1r, base)), o, ring=True,
        **kw)
    return got.numpy(), chg.numpy()


def _rounds_match_jax(form, o, B, N):
    """A round at orientation o with every block dirty, and one at the next
    orientation on a sparse frontier (two flags in opposite corners: the
    seven blocks of their neighbourhoods relax), each from a canvas on its
    way, so that every relaxed block moves by far more than an ulp."""
    nb = N // B
    sparse = np.zeros((nb, nb), np.int32)
    sparse[0, 0] = sparse[-1, -1] = 1
    for orient, prev in ((o, None), ((o + 1) % 4, sparse)):
        xr, Kr, W1r, base, subset = _case(form, 21 + 4 * o + orient, N)
        want, want_chg = _jax_round(xr, Kr, W1r, base, orient, subset, prev,
                                    B)
        got, chg = _port_round(form, xr, Kr, W1r, base, orient, subset, prev,
                               B)
        np.testing.assert_array_equal(chg, want_chg)
        visited = set(t_ub.visit_sequence(nb, nb, orient, subset))
        if prev is not None:
            dirty = t_ub._dirty(torch.from_numpy(prev)).numpy()
            visited &= set(np.flatnonzero(dirty))
        assert int(chg.sum()) == len(visited) > 0
        np.testing.assert_array_almost_equal(got, want, decimal=10)
        inner = np.zeros(got.shape, bool)
        inner[1:-1, 1:-1] = True
        np.testing.assert_array_equal(got[~inner], xr[~inner])


@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("form", ["canvas", "ring", "interior", "boundary"])
def test_rounds_at_b128_match_jax(form, o):
    """A round at orientation o with every block dirty, and one at the next
    orientation on a sparse frontier (two flags in opposite corners: the
    seven blocks of their neighbourhoods relax), each from a canvas on its
    way, so that every relaxed block moves by far more than an ulp."""
    _rounds_match_jax(form, o, B, N)


@pytest.mark.parametrize("o", range(4))
@pytest.mark.parametrize("form", ["canvas", "ring", "interior", "boundary"])
@pytest.mark.parametrize("b", [32, 8])
def test_rounds_at_mesh_block_sizes_match_jax(b, form, o):
    """The same at the B = 32 and 8 that the mesh takes for shards that 64
    or 16 does not divide, on their 3x3 block grids."""
    _rounds_match_jax(form, o, b, 3 * b)
