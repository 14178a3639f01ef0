"""The Nystrom passes' tensor-core decomposition, emulated on the CPU.

The CUDA kernel (csrc/landmarks.cu, nystrom_kernel) starts each exponent
at c |x|^2 + c |y|^2 in fp32 and adds the cross term -2c x . y as one
mma.sync m16n8k16 product (two at D = 8) of fp16 operands split into hi
and lo parts: rows [hi(a) | lo(a) | hi(a)], keys [hi(y) | hi(y) | lo(y)]
with a = -2c x, zero up to 16 columns, fp32 accumulators.  Then
w = 2^min(e, 0), and each thread of a quad sums the keys 2t and 2t + 1 of
every 8 keys with FMAs in key order, the quad's four sums are added with
two shuffles, and pass 1's slices of P are added in a fixed order.  A
float32 emulation of exactly that is held against the plain versions and
against the JAX package's fused filter (nystrom_filter_pallas in interpret
mode, as the JAX tests run it), at small sizes with ragged P and M, D = 3,
5 and 8, and K = 2 and 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.ops import crf as jcrf
from tcam_wsol_video_tpu.ops.pallas.landmarks import nystrom_filter_pallas
from tcam_wsol_video_tpu_torch.ops import linalg
from tcam_wsol_video_tpu_torch.ops.cuda import build, landmarks

torch.set_num_threads(1)

C_EXP2 = np.float32(-0.72134752044448170368)   # -log2(e) / 2, as the kernel
# pass 1 against its plain version, relative to the largest output
# (chip_smoke.py's bound for the kernel on the card)
FILTER_RTOL = 2e-4
# pass 2 and the whole filter: the ridge solve (K_mm + 1e-2 I) passes the
# weights' differences on (chip_smoke.py's bound)
LMK_RTOL = 1e-3
# |e - the float64 exponent| of the split product: ~2^-22 of each term,
# the terms up to ~2e2 at these features (see landmarks.cu)
EXP_ATOL = 2e-4


def f16(x: np.ndarray) -> np.ndarray:
    """__float2half_rn: round to fp16 (nearest, ties to even), as float32."""
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def fma(a, b, c):
    """fmaf in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def split(x: np.ndarray):
    """hi = fp16(x), lo = fp16(x - hi), in float32 (x - hi is exact)."""
    hi = f16(x)
    return hi, f16(x - hi)


def norms(x: np.ndarray) -> np.ndarray:
    """c |x|^2 in float32, the squares by FMAs in feature order."""
    sq = np.zeros(x.shape[:2], np.float32)
    for j in range(x.shape[2]):
        sq = fma(x[..., j], x[..., j], sq)
    return C_EXP2 * sq


def operands(x: np.ndarray, rows: bool, split_parts: bool = True
             ) -> np.ndarray:
    """(B, N, D) float32 -> (B, N, 16 S): the cross term's fp16 operand
    columns, rows [hi(a) | lo(a) | hi(a)] with a = -2c x and keys [hi(y) |
    hi(y) | lo(y)], zero up to a multiple of 16.  split_parts=False: plain
    fp16, rows [fp16(a)] and keys [fp16(y)]."""
    v = np.float32(-2.0 * C_EXP2) * x if rows else x
    if split_parts:
        hi, lo = split(v)
        cols = np.concatenate([hi, lo, hi] if rows else [hi, hi, lo], -1)
    else:
        cols = f16(v)
    width = 16 * (-(-cols.shape[-1] // 16))
    out = np.zeros(x.shape[:2] + (width,), np.float32)
    out[..., :cols.shape[-1]] = cols
    return out


def exponents(rowf: np.ndarray, keyf: np.ndarray,
              split_parts: bool = True) -> np.ndarray:
    """(B, NR, NK) exponents as the kernel forms them: the accumulator
    starts at fp32(c |x|^2 + c |y|^2), then each k = 16 step adds its 16
    products, summed exactly, with one float32 rounding.  split_parts=False:
    plain fp16 operands (no lo parts)."""
    a = operands(rowf, True, split_parts)
    bk = operands(keyf, False, split_parts)
    e = (norms(rowf)[:, :, None] + norms(keyf)[:, None, :]).astype(np.float32)
    for s in range(a.shape[-1] // 16):
        sl = slice(16 * s, 16 * s + 16)
        e = (e + np.einsum("brc,bkc->brk", a[..., sl].astype(np.float64),
                           bk[..., sl].astype(np.float64))).astype(np.float32)
    return e


def emulate_pass(rowf, keyf, kv, nsplit: int):
    """out (B, NR, K): each row's keys, slice by slice of nsplit, 8-key
    tiles, thread t of a quad on keys 2t and 2t + 1 by FMAs in key order,
    the quad's sums added as the shuffles add them, the slices in order."""
    b, nr, _ = rowf.shape
    nk, k = keyf.shape[1], kv.shape[2]
    w = np.exp2(np.minimum(exponents(rowf, keyf), np.float32(0.0)))
    chunk = -(-nk // nsplit)
    total = np.zeros((b, nr, k), np.float32)
    for s in range(nsplit):
        kb, ke = min(nk, s * chunk), min(nk, s * chunk + chunk)
        n = -(-(ke - kb) // 8) * 8
        ws = np.zeros((b, nr, n), np.float32)
        vs = np.zeros((b, n, k), np.float32)      # zero past the slice
        ws[..., :ke - kb] = w[..., kb:ke]
        vs[:, :ke - kb] = kv[:, kb:ke]
        quad = np.zeros((4, b, nr, k), np.float32)
        for j in range(0, n, 8):
            for t in range(4):
                for key in (j + 2 * t, j + 2 * t + 1):
                    quad[t] = fma(ws[..., key, None], vs[:, None, key],
                                  quad[t])
        total = total + ((quad[0] + quad[1]) + (quad[2] + quad[3]))
    return total


def _inputs(b, h, w, sigma_xy, m_req, k, dpad, seed=0):
    rng = np.random.default_rng(seed)
    imgs = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    f = np.stack([np.asarray(jcrf.make_bilateral_features(
        jnp.asarray(im), 15.0, sigma_xy)) for im in imgs])
    if dpad:
        f = np.concatenate([f, rng.standard_normal(
            (b, h * w, dpad)).astype(np.float32)], -1)
    f = (f - f.mean(1, keepdims=True)).astype(np.float32)
    vals = rng.random((b, h * w, k)).astype(np.float32)
    idx = np.asarray(jcrf._landmark_grid_indices(h, w, m_req))
    return f, vals, idx


def _padded(x: np.ndarray, widths) -> np.ndarray:
    """The wrapper's zero padding of D or K to an instantiated width."""
    return build.pad_last(torch.from_numpy(x), widths).numpy()


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# P = 575 and 874 are no multiple of 8 (a ragged last tile per slice),
# M = 126, 60 and 100 no multiple of 16 (ragged row tiles); pass 1 runs in
# 5 or 7 slices of P
CASES = {
    "D5_K2_P576_M128": (2, 24, 24, 100.0, 128, 2, 0),
    "ragged_B1_P575_M60": (1, 23, 25, 100.0, 60, 2, 0),
    "D3_color_only": (2, 24, 24, None, 128, 2, 0),
    "K5_as_K8_P874": (1, 23, 38, 100.0, 100, 5, 0),
    "D8_two_k_steps": (2, 20, 24, 100.0, 128, 2, 3),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def emulated(request):
    b, h, w, sxy, m_req, k, dpad = CASES[request.param]
    f, vals, idx = _inputs(b, h, w, sxy, m_req, k, dpad)
    fm = np.ascontiguousarray(f[:, idx])
    fp = _padded(f, landmarks._KERNEL_D)
    fmp = _padded(fm, landmarks._KERNEL_D)
    vp = _padded(vals, landmarks._KERNEL_K)
    p, m = f.shape[1], fm.shape[0 + 1]
    nsplit = landmarks.rhs_splits(b, p, m)
    rhs = emulate_pass(fmp, fp, vp, nsplit)[..., :k]
    tf, tv = torch.from_numpy(f), torch.from_numpy(vals)
    tfm = torch.from_numpy(fm)
    kmm = landmarks.add_ridge(landmarks.build_knm_plain(tfm, tfm), 1e-2)
    alpha = linalg.batched_cholesky_solve(kmm, torch.from_numpy(rhs))
    out = emulate_pass(fp, fmp, _padded(alpha.numpy(), landmarks._KERNEL_K),
                       1)[..., :k]
    # pass 2 on its own, from the plain version's alpha
    alpha_plain = linalg.batched_cholesky_solve(
        kmm, landmarks.nystrom_rhs_plain(tf, tfm, tv))
    out_alone = emulate_pass(fp, fmp, _padded(alpha_plain.numpy(),
                                              landmarks._KERNEL_K), 1)[..., :k]
    return dict(f=f, fm=fm, vals=vals, idx=idx, nsplit=nsplit, rhs=rhs,
                out=out, out_alone=out_alone, alpha_plain=alpha_plain,
                fp=fp, fmp=fmp)


def test_emulated_pass1_matches_plain(emulated):
    want = landmarks.nystrom_rhs_plain(torch.from_numpy(emulated["f"]),
                                       torch.from_numpy(emulated["fm"]),
                                       torch.from_numpy(emulated["vals"]))
    assert emulated["nsplit"] > 1
    assert np.isfinite(emulated["rhs"]).all()
    assert _rel(emulated["rhs"], want.numpy()) <= FILTER_RTOL


def test_emulated_pass2_matches_plain(emulated):
    want = landmarks.nystrom_out_plain(torch.from_numpy(emulated["f"]),
                                       torch.from_numpy(emulated["fm"]),
                                       emulated["alpha_plain"])
    assert _rel(emulated["out_alone"], want.numpy()) <= LMK_RTOL


def test_emulated_filter_matches_jax_pallas(emulated):
    want = np.asarray(nystrom_filter_pallas(
        jnp.asarray(emulated["f"]), jnp.asarray(emulated["vals"]),
        jnp.asarray(emulated["idx"]), interpret=True))
    assert emulated["out"].shape == want.shape
    assert _rel(emulated["out"], want) <= LMK_RTOL


def test_split_exponent_error(emulated):
    """The split product against the exponent in float64; plain fp16 (no
    lo parts) is far off at these norms, which is why the kernel splits."""
    fmp, fp = emulated["fmp"], emulated["fp"]
    d = fp.shape[2]
    exact = (np.float64(C_EXP2) * (
        (fmp[:, :, None, :d].astype(np.float64)
         - fp[:, None, :, :d].astype(np.float64)) ** 2).sum(-1))
    err = np.abs(exponents(fmp, fp) - exact).max()
    plain = np.abs(exponents(fmp, fp, split_parts=False) - exact).max()
    assert err <= EXP_ATOL, err
    assert plain > 100 * EXP_ATOL, plain
