"""Port parity: the exact dense bilateral filter and the CRF loss.

The port's filter (plain version on the CPU) is held against the JAX
package's portable filter and its Pallas kernel in interpret mode; the
CRF loss value and its segs-gradient against jax.grad.  Inputs are made
with numpy from a seed and run in float32 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.ops import crf as jcrf
from tcam_wsol_video_tpu.ops.pallas.bilateral import \
    gaussian_filter_apply_pallas_batched
from tcam_wsol_video_tpu_torch.ops import crf as tcrf
from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

torch.set_num_threads(1)

# fp32 sums of up to ~200 Gaussian weights in another order; the JAX
# package's own Pallas-vs-XLA test uses 3e-4 (tests/test_ops.py)
FILTER_RTOL = 3e-4
# loss value, and the gradient in relative L2 norm: both sums of the
# filter's output, where the per-element float noise averages out
CRF_RTOL = 1e-5


def _images(rng, b, h, w):
    return (rng.random((b, h, w, 3)) * 255).astype(np.float32)


@pytest.mark.parametrize("sigma_xy,h,w", [(100.0, 12, 14), (None, 12, 14),
                                          (100.0, 7, 11)],
                         ids=["D5", "D3_color_only", "D5_ragged_P77"])
def test_plain_filter_matches_jax_filters(sigma_xy, h, w):
    rng = np.random.default_rng(0)
    b = 3
    imgs = _images(rng, b, h, w)
    segs = rng.random((b, h * w, 2)).astype(np.float32)
    jfeats = jnp.stack([jcrf.make_bilateral_features(jnp.asarray(im), 15.0,
                                                     sigma_xy)
                        for im in imgs])
    tfeats = tcrf.make_bilateral_features(torch.from_numpy(imgs), 15.0,
                                          sigma_xy)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats),
                               rtol=1e-6, atol=1e-6)

    want_xla = np.stack([np.asarray(jcrf.gaussian_filter_apply(
        jfeats[i], jnp.asarray(segs[i]))) for i in range(b)])
    want_pallas = np.asarray(gaussian_filter_apply_pallas_batched(
        jfeats, jnp.asarray(segs), interpret=True))
    got = bilateral.gaussian_filter_apply_batched(
        tfeats.contiguous(), torch.from_numpy(segs)).numpy()
    got_single = bilateral.gaussian_filter_apply(
        tfeats[0].contiguous(), torch.from_numpy(segs[0])).numpy()
    for want in (want_xla, want_pallas):
        np.testing.assert_allclose(got, want, rtol=FILTER_RTOL,
                                   atol=FILTER_RTOL)
    np.testing.assert_allclose(got_single, want_xla[0], rtol=FILTER_RTOL,
                               atol=FILTER_RTOL)


def test_filter_wrapper_refuses_bad_inputs():
    f = torch.zeros((1, 10, 9))
    v = torch.zeros((1, 10, 2))
    with pytest.raises(ValueError):
        bilateral.gaussian_filter_apply_batched(f, v)          # D > 8
    with pytest.raises(TypeError):
        bilateral.gaussian_filter_apply_batched(
            torch.zeros((1, 10, 5), dtype=torch.float64), v)
    with pytest.raises(ValueError):
        bilateral.gaussian_filter_apply_batched(torch.zeros((1, 11, 5)), v)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_dense_crf_loss_and_grad_match_jax(scale):
    rng = np.random.default_rng(1)
    b, h, w = 2, 12, 16
    imgs = _images(rng, b, h, w)
    logits = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    segs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))

    def jloss(s):
        return jcrf.dense_crf_loss(jnp.asarray(imgs), s, 15.0, 100.0,
                                   scale_factor=scale)
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(segs))

    s = torch.from_numpy(segs).requires_grad_(True)
    got = tcrf.dense_crf_loss(torch.from_numpy(imgs), s, 15.0, 100.0,
                              scale_factor=scale)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=CRF_RTOL)
    g = s.grad.numpy()
    want_g = np.asarray(want_g)
    assert np.linalg.norm(g - want_g) <= CRF_RTOL * np.linalg.norm(want_g)


def test_color_dense_crf_loss_matches_jax():
    rng = np.random.default_rng(2)
    imgs = _images(rng, 2, 8, 24)
    segs = rng.random((2, 8, 24, 2)).astype(np.float32)
    want = jcrf.color_dense_crf_loss(jnp.asarray(imgs), jnp.asarray(segs),
                                     15.0)
    got = tcrf.color_dense_crf_loss(torch.from_numpy(imgs),
                                    torch.from_numpy(segs), 15.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=CRF_RTOL)


@pytest.mark.parametrize("scale,n_landmarks", [(1.0, 128), (0.5, 64)])
def test_landmark_crf_loss_and_grad_match_jax(scale, n_landmarks):
    rng = np.random.default_rng(3)
    b, h, w = 2, 24, 24
    imgs = _images(rng, b, h, w)
    logits = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    segs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))

    def jloss(s):
        return jcrf.dense_crf_loss(jnp.asarray(imgs), s, 15.0, 100.0,
                                   scale_factor=scale, method="landmarks",
                                   n_landmarks=n_landmarks)
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(segs))

    s = torch.from_numpy(segs).requires_grad_(True)
    got = tcrf.dense_crf_loss(torch.from_numpy(imgs), s, 15.0, 100.0,
                              scale_factor=scale, method="landmarks",
                              n_landmarks=n_landmarks)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=CRF_RTOL)
    g = s.grad.numpy()
    want_g = np.asarray(want_g)
    assert np.linalg.norm(g - want_g) <= CRF_RTOL * np.linalg.norm(want_g)


def test_color_landmark_crf_loss_matches_jax():
    rng = np.random.default_rng(4)
    imgs = _images(rng, 2, 12, 36)
    segs = rng.random((2, 12, 36, 2)).astype(np.float32)
    want = jcrf.color_dense_crf_loss(jnp.asarray(imgs), jnp.asarray(segs),
                                     15.0, method="landmarks",
                                     n_landmarks=96)
    got = tcrf.color_dense_crf_loss(torch.from_numpy(imgs),
                                    torch.from_numpy(segs), 15.0,
                                    method="landmarks", n_landmarks=96)
    np.testing.assert_allclose(got.item(), float(want), rtol=CRF_RTOL)


def test_unknown_crf_method_raises():
    with pytest.raises(ValueError):
        tcrf.bilateral_filter_batch(torch.zeros((1, 4, 4, 3)),
                                    torch.zeros((1, 4, 4, 2)), 15.0, 100.0,
                                    method="lattice")


def test_mean_field_refine_matches_jax():
    from tcam_wsol_video_tpu.ops.crf_inference import \
        mean_field_refine as jrefine
    from tcam_wsol_video_tpu_torch.ops.crf_inference import mean_field_refine
    rng = np.random.default_rng(5)
    imgs = _images(rng, 2, 24, 24)
    cam = rng.random((2, 24, 24)).astype(np.float32)
    probs = np.stack([1.0 - cam, cam], axis=-1)
    want = np.asarray(jrefine(jnp.asarray(imgs), jnp.asarray(probs)))
    got = mean_field_refine(torch.from_numpy(imgs),
                            torch.from_numpy(probs)).numpy()
    # five iterations of softmax(-U + w (W q - q)): the filter's fp32
    # noise (FILTER_RTOL of AS ~ 1e2) passes through the softmax
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
