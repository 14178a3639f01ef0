"""The exact bilateral kernel's decomposition, on the CPU.

The CUDA kernel (csrc/bilateral.cu) computes each unordered tile pair once
on the circulant schedule of ops/cuda/bilateral.schedule, writes row and
column partial sums into scratch slots, and a second kernel adds the
slots in a fixed order.  These tests hold the schedule's coverage (every
unordered tile pair once, every diagonal tile once, every scratch entry
written at most once and read only if written) and a float32 emulation of
the whole decomposition, at small tiles, against the JAX package's filter
and its Pallas kernel in interpret mode.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.ops import crf as jcrf
from tcam_wsol_video_tpu.ops.pallas.bilateral import \
    gaussian_filter_apply_pallas_batched
from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, build

torch.set_num_threads(1)

# as tests/test_torch_crf.py: fp32 sums in another order; the JAX
# package's own Pallas-vs-XLA test uses 3e-4
FILTER_RTOL = 3e-4
C_EXP2 = -0.5 / math.log(2.0)   # w = 2^(c d2) = exp(-d2 / 2)


def _blocks(sch):
    """(row tile, piece, offsets) of every block of one image."""
    return [(i, s, sch.block_offsets(i, s))
            for i in range(sch.n_tiles) for s in range(sch.nsplit)]


@pytest.mark.parametrize("n,batch,n_sm", [
    (1, 1, 132), (2, 1, 132), (3, 2, 4), (4, 1, 132), (7, 3, 1), (8, 1, 132),
    (9, 1, 132), (196, 32, 132), (196, 1, 132)],
    ids=["n1", "n2", "n3_split", "n4_split", "n7", "n8_split", "n9_split",
         "recipe_B32", "recipe_B1_split"])
def test_schedule_covers_each_pair_once(n, batch, n_sm):
    tile = 16
    sch = bilateral.schedule(batch, n * tile - 3, 2, n_sm, tile=tile)
    assert sch.n_tiles == n and sch.batch == batch
    if batch * n < bilateral.BLOCKS_PER_SM * n_sm and n > 1:
        assert sch.nsplit > 1           # small grids split their strips
    pairs, diag = {}, {}
    col_written = {}
    for i, s, offs in _blocks(sch):
        assert offs.start >= 0
        for o in offs:
            j = (i + o) % n
            if o == 0:
                diag[i] = diag.get(i, 0) + 1
                continue
            key = (min(i, j), max(i, j))
            pairs[key] = pairs.get(key, 0) + 1
            slot = sch.nsplit + o - 1
            assert slot < sch.scratch_shape[1]
            col_written[(slot, j)] = col_written.get((slot, j), 0) + 1
    # each row tile's offsets are cut into disjoint pieces that cover them
    for i in range(n):
        got = [o for s in range(sch.nsplit) for o in sch.block_offsets(i, s)]
        assert got == list(range(sch.row_offsets(i)))
    assert diag == {i: 1 for i in range(n)}
    assert pairs == {(i, j): 1 for i in range(n) for j in range(i + 1, n)}
    assert all(c == 1 for c in col_written.values())
    # the reduction reads slots nsplit .. nsplit + column_slots(j) - 1 of
    # column tile j: exactly the ones written
    for j in range(n):
        read = {(sch.nsplit + t, j) for t in range(sch.column_slots(j))}
        assert read == {key for key in col_written if key[1] == j}
    work = [sch.row_offsets(i) for i in range(n)]
    assert max(work) - min(work) <= 1   # balanced strips


def test_schedule_at_the_recipe_shape():
    sch = bilateral.schedule(32, 224 * 224, 2, 132)
    assert (sch.n_tiles, sch.nsplit) == (196, 1)
    assert sch.scratch_shape == (32, 99, 224 * 224, 2)
    single = bilateral.schedule(1, 224 * 224, 2, 132)
    assert single.nsplit > 1
    # grid (n_tiles nsplit, B): enough blocks for every SM
    assert single.n_tiles * single.nsplit >= bilateral.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("batch,pixels,cap", [
    (32, 224 * 224, bilateral.SCRATCH_CAP), (32, 224 * 448,
                                             bilateral.SCRATCH_CAP),
    (5, 3000, 1), (7, 5000, 10 ** 6)])
def test_plan_chunks_the_batch_under_the_cap(batch, pixels, cap):
    chunks = bilateral.plan(batch, pixels, 2, 132, cap=cap)
    starts = [b0 for b0, _ in chunks]
    sizes = [sch.batch for _, sch in chunks]
    assert starts == [sum(sizes[:i]) for i in range(len(sizes))]
    assert sum(sizes) == batch
    for _, sch in chunks:
        assert sch.scratch_bytes <= cap or sch.batch == 1
    if pixels == 224 * 224:
        assert len(chunks) == 1     # the recipe's call is one launch pair


def emulate(feats: torch.Tensor, vals: torch.Tensor, tile: int,
            n_sm: int) -> torch.Tensor:
    """The kernel's decomposition in float32: tiles, the diagonal tile in
    the row direction, column partials of the off-diagonal pairs into
    their slots, and the fixed-order reduction.  Scratch starts as NaN so
    that reading an unwritten slot shows."""
    b, p, _ = feats.shape
    f = build.pad_last(feats - feats.mean(1, keepdim=True),
                       bilateral._KERNEL_D)
    v = build.pad_last(vals, bilateral._KERNEL_K)
    k = v.shape[2]
    sch = bilateral.schedule(b, p, k, n_sm, tile=tile)
    n = sch.n_tiles
    pad = n * tile - p
    valid = torch.arange(n * tile) < p
    f = torch.nn.functional.pad(f, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    q = torch.where(valid, C_EXP2 * (f * f).sum(-1),
                    torch.tensor(-math.inf))                   # (B, n T)
    h = -2.0 * C_EXP2 * f
    scratch = torch.full(sch.scratch_shape, math.nan)

    def weights(i, j):
        ri = slice(i * tile, (i + 1) * tile)
        rj = slice(j * tile, (j + 1) * tile)
        e = (q[:, ri, None] + q[:, None, rj]
             + torch.bmm(h[:, ri], f[:, rj].transpose(1, 2)))
        return torch.exp2(torch.clamp_max(e, 0.0)), ri, rj

    def put(slot, t, x):
        lo, hi = t * tile, min(p, (t + 1) * tile)
        assert torch.isnan(scratch[:, slot, lo:hi]).all(), "written twice"
        scratch[:, slot, lo:hi] = x[:, :hi - lo]

    for i, s, offs in _blocks(sch):
        acc = torch.zeros((b, tile, k))
        for o in offs:
            j = (i + o) % n
            w, ri, rj = weights(i, j)
            acc += torch.bmm(w, v[:, rj])
            if o > 0:
                put(sch.nsplit + o - 1, j,
                    torch.bmm(w.transpose(1, 2), v[:, ri]))
        put(s, i, acc)

    out = torch.empty((b, p, k))
    for j in range(n):
        lo, hi = j * tile, min(p, (j + 1) * tile)
        acc = torch.zeros((b, hi - lo, k))
        for t in range(sch.nsplit + sch.column_slots(j)):
            acc = acc + scratch[:, t, lo:hi]
        out[:, lo:hi] = acc
    return out[..., :vals.shape[2]]


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("sigma_xy", [100.0, None], ids=["D5", "D3"])
@pytest.mark.parametrize("h,w", [(7, 11), (12, 14)],
                         ids=["ragged_P77", "P168"])
def test_emulated_decomposition_matches_jax(h, w, sigma_xy, k):
    rng = np.random.default_rng(7)
    b = 2
    imgs = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    vals = rng.random((b, h * w, k)).astype(np.float32)
    jfeats = jnp.stack([jcrf.make_bilateral_features(jnp.asarray(im), 15.0,
                                                     sigma_xy)
                        for im in imgs])
    want_xla = np.stack([np.asarray(jcrf.gaussian_filter_apply(
        jfeats[i], jnp.asarray(vals[i]))) for i in range(b)])
    want_pallas = np.asarray(gaussian_filter_apply_pallas_batched(
        jfeats, jnp.asarray(vals), interpret=True))
    feats = torch.from_numpy(np.array(jfeats))
    # tile 16: 5 and 11 tiles (odd); tile 32: 3 (odd) and 6 (even); n_sm
    # 64 splits every strip
    for tile in (16, 32):
        for n_sm in (1, 64):
            got = emulate(feats, torch.from_numpy(vals), tile, n_sm).numpy()
            assert np.isfinite(got).all()
            for want in (want_xla, want_pallas):
                np.testing.assert_allclose(got, want, rtol=FILTER_RTOL,
                                           atol=FILTER_RTOL)
