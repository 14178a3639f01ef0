"""Port parity: the landmark (Nystrom) CRF filter, its two kernels' plain
versions, the Cholesky solve and the random-feature filter.

The port's functions (plain versions on the CPU) are held against the
JAX package: the landmark grid, _kmat_batched and build_knm_pallas,
gaussian_filter_apply_landmarks (cho and lockstep solvers),
nystrom_filter_pallas (whose solve is the lockstep one, as the port's
fused route's) and batched_block_cholesky_solve, the Pallas kernels in
interpret mode as the
JAX package's own tests run them.  Inputs are made with numpy from a
seed and run in float32 on both sides; sizes stay at 24x24 and M <= 512.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import cho_factor, cho_solve

from tcam_wsol_video_tpu.ops import crf as jcrf
from tcam_wsol_video_tpu.ops.linalg import batched_block_cholesky_solve
from tcam_wsol_video_tpu.ops.pallas.landmarks import (build_knm_pallas,
                                                      nystrom_filter_pallas)
from tcam_wsol_video_tpu_torch.ops import crf as tcrf
from tcam_wsol_video_tpu_torch.ops import linalg
from tcam_wsol_video_tpu_torch.ops.cuda import landmarks

torch.set_num_threads(1)

# kernel entries in [0, 1]: fp32 cancellation noise of the norm expansion
# d2 = |a|^2 + |b|^2 - 2 a.b, rounded in another order (tests/test_ops.py
# uses the same bound for the Pallas build kernel)
KNM_ATOL = 1e-4
# the filter and the fused filter, relative L2: the same math to fp32
# accumulation and solve noise (tests/test_ops.py's bound)
FILTER_RTOL = 1e-5
# bf16 K_nm storage against fp32: bounded error, the JAX package's bound
BF16_RTOL = 1e-2
# the Cholesky solve against float64 numpy and both JAX solvers (cho and
# lockstep), relative L2 (fp32 at condition numbers up to ~1e5)
SOLVE_RTOL = 5e-4
# random features: fp32 cos/sin of the same arguments, summed over 1000
# frequencies in the same chunks
RFF_RTOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _centred_feats(rng, b, h, w, sigma_xy=100.0):
    imgs = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    f = jax.vmap(lambda im: jcrf.make_bilateral_features(im, 15.0, sigma_xy)
                 )(jnp.asarray(imgs))
    return np.array(f - jnp.mean(f, axis=1, keepdims=True))


@pytest.mark.parametrize("h,w,m,m_real", [(224, 224, 1024, 1024),
                                          (24, 24, 512, 506),
                                          (37, 53, 128, 126)])
def test_landmark_grid_indices_match_jax(h, w, m, m_real):
    got = tcrf._landmark_grid_indices(h, w, m)
    want = np.asarray(jcrf._landmark_grid_indices(h, w, m))
    assert got.shape == (m_real,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [5, 3])
def test_build_knm_plain_matches_jax(d):
    rng = np.random.default_rng(0)
    h = w = 24
    f = _centred_feats(rng, 2, h, w, 100.0 if d == 5 else None)
    idx = np.asarray(jcrf._landmark_grid_indices(h, w, 128))
    m = idx.shape[0]
    fm = f[:, idx]
    # the Pallas build kernel wants M padded to 128 with 1e6 features
    fmp = np.pad(fm, ((0, 0), (0, 128 - m), (0, 0)), constant_values=1e6)
    pallas = np.asarray(build_knm_pallas(jnp.asarray(f), jnp.asarray(fmp),
                                         interpret=True))[:, :h * w, :m]
    kmat = np.asarray(jcrf._kmat_batched(jnp.asarray(f), jnp.asarray(fm)))
    before = landmarks.knm_counts.plain
    got = landmarks.build_knm(torch.from_numpy(f), torch.from_numpy(fm))
    assert landmarks.knm_counts.plain == before + 1
    assert got.dtype == torch.float32 and got.shape == (2, h * w, m)
    for want in (pallas, kmat):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KNM_ATOL)
    bf16 = landmarks.build_knm(torch.from_numpy(f), torch.from_numpy(fm),
                               out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def _filter_inputs(b, h=24, w=24, k=2, seed=1):
    rng = np.random.default_rng(seed)
    f = _centred_feats(rng, b, h, w)
    vals = rng.random((b, h * w, k)).astype(np.float32)
    return f, vals


@pytest.mark.parametrize("group", [1, 2, 3])
def test_landmark_filter_groups_match_jax(group):
    b = 5  # 5 = 2 + 2 + 1: a ragged last group
    f, vals = _filter_inputs(b)
    idx = jcrf._landmark_grid_indices(24, 24, 128)
    want = np.asarray(jcrf.gaussian_filter_apply_landmarks(
        jnp.asarray(f), jnp.asarray(vals), idx, group=b, solver="cho"))
    got = tcrf.gaussian_filter_apply_landmarks(
        torch.from_numpy(f), torch.from_numpy(vals), np.asarray(idx),
        group=group, fused=False).numpy()
    assert _rel(got, want) < FILTER_RTOL


def test_landmark_filter_bf16_knm_and_env_knobs(monkeypatch):
    b = 5
    f, vals = _filter_inputs(b)
    idx = np.asarray(jcrf._landmark_grid_indices(24, 24, 128))
    ref = np.asarray(jcrf.gaussian_filter_apply_landmarks(
        jnp.asarray(f), jnp.asarray(vals), idx, group=b))
    tf, tv = torch.from_numpy(f), torch.from_numpy(vals)
    bf16 = tcrf.gaussian_filter_apply_landmarks(
        tf, tv, idx, knm_dtype=torch.bfloat16, fused=False).numpy()
    assert _rel(bf16, ref) < BF16_RTOL
    # the environment knobs select the same computation as the arguments
    monkeypatch.setenv("TCAM_KNM_DTYPE", "bfloat16")
    monkeypatch.setenv("TCAM_LMK_GROUP", "2")
    monkeypatch.delenv("TCAM_FUSED_LANDMARKS", raising=False)
    env = tcrf.gaussian_filter_apply_landmarks(tf, tv, idx).numpy()
    arg = tcrf.gaussian_filter_apply_landmarks(
        tf, tv, idx, group=2, knm_dtype=torch.bfloat16, fused=False).numpy()
    np.testing.assert_array_equal(env, arg)
    monkeypatch.setenv("TCAM_KNM_DTYPE", "float16")
    with pytest.raises(ValueError):
        tcrf.gaussian_filter_apply_landmarks(tf, tv, idx, fused=False)


def test_lockstep_solver_is_not_ported(monkeypatch):
    """The name predates the port of the lockstep solver: now
    TCAM_LMK_SOLVER=lockstep selects it at call time, and the build
    route's filter equals JAX's under solver="lockstep" (121 and 506
    landmarks, padded to 128 and 512 with identity rows on both sides);
    another value is refused."""
    f, vals = _filter_inputs(2, seed=6)
    tf, tv = torch.from_numpy(f), torch.from_numpy(vals)
    for m_req in (128, 512):
        idx = np.asarray(jcrf._landmark_grid_indices(24, 24, m_req))
        want = np.asarray(jcrf.gaussian_filter_apply_landmarks(
            jnp.asarray(f), jnp.asarray(vals), jnp.asarray(idx),
            solver="lockstep"))
        monkeypatch.setenv("TCAM_LMK_SOLVER", "lockstep")
        with linalg.record_info() as infos:
            got = tcrf.gaussian_filter_apply_landmarks(tf, tv, idx,
                                                       fused=False).numpy()
        assert infos == []                  # no cholesky_ex call
        assert _rel(got, want) < FILTER_RTOL
        monkeypatch.setenv("TCAM_LMK_SOLVER", "cho")
        cho = tcrf.gaussian_filter_apply_landmarks(tf, tv, idx, fused=False)
        assert _rel(cho.numpy(), want) < FILTER_RTOL
    monkeypatch.setenv("TCAM_LMK_SOLVER", "qr")
    with pytest.raises(ValueError):
        tcrf.gaussian_filter_apply_landmarks(tf, tv, idx, fused=False)


@pytest.mark.parametrize("m", [128, 256, 300])
def test_lockstep_solve_matches_jax(m):
    """The port's lockstep solve against JAX's batched_block_cholesky_solve
    on ridge-regularized Gaussian kernel systems (M = 300 padded to 384
    with identity rows, as the landmark filter pads it), and against
    float64 numpy."""
    rng = np.random.default_rng(m)
    g, k = 3, 2
    x = rng.standard_normal((g, m, 5)).astype(np.float32)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    a = (np.exp(-0.5 * d2) + 1e-2 * np.eye(m)).astype(np.float32)
    b = rng.standard_normal((g, m, k)).astype(np.float32)
    mp = -(-m // linalg.NB) * linalg.NB
    ap = np.tile(np.eye(mp, dtype=np.float32), (g, 1, 1))
    ap[:, :m, :m] = a
    bp = np.pad(b, ((0, 0), (0, mp - m), (0, 0)))
    want = np.asarray(batched_block_cholesky_solve(jnp.asarray(ap),
                                                   jnp.asarray(bp)))[:, :m]
    got = linalg.lockstep_solve(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    exact = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert _rel(got, want) < SOLVE_RTOL
    assert _rel(got, exact) < SOLVE_RTOL
    if m % linalg.NB:
        with pytest.raises(ValueError):
            linalg.batched_block_cholesky_solve(torch.from_numpy(a),
                                                torch.from_numpy(b))


@pytest.mark.parametrize("m_req", [128, 512])
def test_nystrom_filter_plain_matches_pallas(m_req, monkeypatch):
    b, k = 2, 2
    f, vals = _filter_inputs(b, k=k, seed=2)
    idx = jcrf._landmark_grid_indices(24, 24, m_req)
    want = np.asarray(nystrom_filter_pallas(jnp.asarray(f),
                                            jnp.asarray(vals), idx,
                                            interpret=True))
    counters = (landmarks.knm_counts, landmarks.rhs_counts,
                landmarks.out_counts)
    before = [(c.kernel, c.plain) for c in counters]
    tf, tv = torch.from_numpy(f), torch.from_numpy(vals)
    tidx = torch.from_numpy(np.array(idx)).long()
    got = landmarks.nystrom_filter_plain(tf, tv, tidx).numpy()
    assert _rel(got, want) < FILTER_RTOL
    # the fused wrapper and the env opt-in take the same plain path on the
    # CPU (counted as plain calls, never as kernel launches)
    fused = landmarks.nystrom_filter(tf, tv, tidx).numpy()
    monkeypatch.setenv("TCAM_FUSED_LANDMARKS", "1")
    opted = tcrf.gaussian_filter_apply_landmarks(tf, tv, np.asarray(idx))
    np.testing.assert_array_equal(fused, got)
    np.testing.assert_array_equal(opted.numpy(), got)
    after = [(c.kernel, c.plain) for c in counters]
    assert [a[0] - b_[0] for a, b_ in zip(after, before)] == [0, 0, 0]
    assert [a[1] - b_[1] for a, b_ in zip(after, before)] == [3, 3, 3]


def test_nystrom_passes_plain_match_bmm():
    f, vals = _filter_inputs(2, seed=3)
    idx = tcrf._landmark_grid_indices(24, 24, 128)
    tf, tv = torch.from_numpy(f), torch.from_numpy(vals)
    fm = tf[:, idx].contiguous()
    knm = torch.from_numpy(np.array(jcrf._kmat_batched(
        jnp.asarray(f), jnp.asarray(f[:, idx]))))
    rhs = landmarks.nystrom_rhs(tf, fm, tv)
    np.testing.assert_allclose(rhs.numpy(), (knm.transpose(1, 2) @ tv).numpy(),
                               rtol=1e-5, atol=1e-3)
    alpha = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, fm.shape[1], 2)).astype(np.float32))
    out = landmarks.nystrom_out(tf, fm, alpha)
    np.testing.assert_allclose(out.numpy(), (knm @ alpha).numpy(),
                               rtol=1e-4, atol=1e-3)


def test_landmark_wrappers_refuse_bad_inputs():
    f = torch.zeros((1, 10, 5))
    fm = torch.zeros((1, 4, 5))
    with pytest.raises(ValueError):
        landmarks.build_knm(torch.zeros((1, 10, 9)), torch.zeros((1, 4, 9)))
    with pytest.raises(ValueError):
        landmarks.build_knm(f, torch.zeros((1, 4, 3)))
    with pytest.raises(TypeError):
        landmarks.build_knm(f.double(), fm.double())
    with pytest.raises(TypeError):
        landmarks.build_knm(f, fm, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        landmarks.nystrom_rhs(f, fm, torch.zeros((1, 10, 9)))
    with pytest.raises(ValueError):
        landmarks.nystrom_out(f, fm, torch.zeros((1, 10, 2)))


def test_batched_cholesky_solve_matches_lockstep_and_numpy():
    rng = np.random.default_rng(5)
    for g, m, k in [(3, 128, 2), (2, 256, 8)]:
        x = rng.standard_normal((g, m, m)).astype(np.float32)
        a = (x @ x.transpose(0, 2, 1)) / m + 0.01 * np.eye(m, dtype=np.float32)
        b = rng.standard_normal((g, m, k)).astype(np.float32)
        want = np.stack([np.linalg.solve(a[i].astype(np.float64), b[i])
                         for i in range(g)])
        lockstep = np.asarray(batched_block_cholesky_solve(jnp.asarray(a),
                                                           jnp.asarray(b)))
        cho = np.stack([np.asarray(cho_solve(cho_factor(jnp.asarray(a[i])),
                                             jnp.asarray(b[i])))
                        for i in range(g)])
        with linalg.record_info() as infos:
            got = linalg.batched_cholesky_solve(torch.from_numpy(a),
                                                torch.from_numpy(b)).numpy()
        assert len(infos) == 1 and int(infos[0].abs().sum()) == 0
        assert _rel(got, want) < SOLVE_RTOL
        assert _rel(got, lockstep) < SOLVE_RTOL
        assert _rel(got, cho) < SOLVE_RTOL
    # a ridge-regularized Gaussian kernel system, as the filter solves it
    f = _centred_feats(rng, 2, 24, 24)
    idx = np.asarray(jcrf._landmark_grid_indices(24, 24, 512))
    fm = f[:, idx]
    kmm = np.asarray(jcrf._kmat_batched(jnp.asarray(fm), jnp.asarray(fm)))
    kmm = kmm + 0.01 * np.eye(fm.shape[1], dtype=np.float32)
    b = rng.random((2, fm.shape[1], 2)).astype(np.float32)
    want = np.stack([np.linalg.solve(kmm[i].astype(np.float64), b[i])
                     for i in range(2)])
    got = linalg.batched_cholesky_solve(torch.from_numpy(kmm),
                                        torch.from_numpy(b)).numpy()
    assert _rel(got, want) < SOLVE_RTOL


def test_rff_filter_matches_jax_with_injected_frequencies():
    rng = np.random.default_rng(6)
    f = _centred_feats(rng, 1, 16, 20)[0]
    vals = rng.random((16 * 20, 2)).astype(np.float32)
    n_freq = 1000  # not a multiple of the 512 chunk
    omega = np.array(jcrf._orthogonal_frequencies(jax.random.PRNGKey(1234),
                                                    n_freq, f.shape[1]))
    want = np.asarray(jcrf.gaussian_filter_apply_rff(
        jnp.asarray(f), jnp.asarray(vals), n_freq=n_freq))
    got = tcrf.gaussian_filter_apply_rff(
        torch.from_numpy(f), torch.from_numpy(vals), n_freq=n_freq,
        omega=torch.from_numpy(omega)).numpy()
    assert _rel(got, want) < RFF_RTOL
    # the port's own fixed frequencies: orthogonal directions within each
    # D x D block, the same for every call
    own = tcrf._fixed_frequencies(n_freq, 5)
    assert own.shape == (n_freq, 5)
    blk = own[:5] / own[:5].norm(dim=1, keepdim=True)
    np.testing.assert_allclose((blk @ blk.T).numpy(), np.eye(5), atol=1e-5)
    a = tcrf.gaussian_filter_apply_rff(torch.from_numpy(f),
                                       torch.from_numpy(vals), n_freq=n_freq)
    b = tcrf.gaussian_filter_apply_rff(torch.from_numpy(f),
                                       torch.from_numpy(vals), n_freq=n_freq)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
