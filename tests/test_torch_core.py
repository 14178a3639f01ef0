"""Port parity of the small modules: constants, KeyChain, resizes, ELB,
the ignore-index CE, CAM extractors, host ROI and Otsu, loss windows.
Inputs from numpy seeds, float32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.cams import extractors as jex
from tcam_wsol_video_tpu.cams import roi as jroi
from tcam_wsol_video_tpu.core import constants as jconst
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.losses.elb import elb as jelb
from tcam_wsol_video_tpu.losses.fcam import cross_entropy_ignore as jce
from tcam_wsol_video_tpu.metrics import otsu_np as jotsu_np
from tcam_wsol_video_tpu.ops import interpolate as jint
from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.cams import roi
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.losses.core import ElementaryLoss
from tcam_wsol_video_tpu_torch.losses.elb import elb
from tcam_wsol_video_tpu_torch.losses.fcam import cross_entropy_ignore
from tcam_wsol_video_tpu_torch.metrics import otsu_np
from tcam_wsol_video_tpu_torch.ops import interpolate as tint

torch.set_num_threads(1)

# separable resizes: two fp32 contractions in another order
RESIZE_TOL = 1e-6
# losses: fp32 log/softmax and a mean in another order
LOSS_RTOL = 1e-6


def test_constants_match_jax():
    for name in dir(constants):
        if name.isupper():
            if name == "NUMBER_CLASSES":
                for k, v in constants.NUMBER_CLASSES.items():
                    assert jconst.NUMBER_CLASSES[k] == v
            else:
                assert getattr(jconst, name) == getattr(constants, name), name


@pytest.mark.parametrize("path", [("data", "train", 0, 3),
                                  ("aug", "val", 2, 5, 1), ()])
def test_keychain_numpy_rng_bit_equal(path):
    got = KeyChain(7).numpy_rng(*path).integers(0, 2 ** 31, 16)
    want = JKeyChain(7).numpy_rng(*path).integers(0, 2 ** 31, 16)
    np.testing.assert_array_equal(got, want)
    a = torch.rand(4, generator=KeyChain(7).key(*path, device="cpu"))
    b = torch.rand(4, generator=KeyChain(7).key(*path, device="cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("size,align", [((13, 9), False), ((13, 9), True),
                                        ((4, 3), False), ((1, 1), True)])
def test_resize_bilinear_matches_jax(size, align):
    x = np.random.default_rng(0).random((2, 7, 6, 3)).astype(np.float32)
    want = np.asarray(jint.resize_bilinear(jnp.asarray(x), size, align))
    got = tint.resize_bilinear(torch.from_numpy(x), size, align).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL)
    got_nchw = tint.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    size, align, layout="nchw")
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(), want,
                               atol=RESIZE_TOL)


def test_resize_nearest_and_decoder_snap_match_jax():
    x = np.random.default_rng(1).random((2, 7, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tint.resize_nearest(torch.from_numpy(x), (14, 14)).numpy(),
        np.asarray(jint.resize_nearest(jnp.asarray(x), (14, 14))))
    want = np.asarray(jint.resize_nearest_then_bilinear(
        jnp.asarray(x), (14, 14), (7, 7), align_corners=True))
    got = tint.resize_nearest_then_bilinear(
        torch.from_numpy(x), (14, 14), (7, 7), align_corners=True).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL)


@pytest.mark.parametrize("t", [1.0, 2.5])
def test_elb_matches_jax(t):
    fx = np.random.default_rng(2).normal(0.0, 2.0, 64).astype(np.float32)
    np.testing.assert_allclose(elb(torch.from_numpy(fx), t).item(),
                               float(jelb(jnp.asarray(fx), t)),
                               rtol=LOSS_RTOL)


def test_cross_entropy_ignore_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 6, 2)).astype(np.float32)
    seeds = rng.choice([0, 1, -255], (2, 5, 6)).astype(np.int32)
    np.testing.assert_allclose(
        cross_entropy_ignore(torch.from_numpy(logits),
                             torch.from_numpy(seeds), -255).item(),
        float(jce(jnp.asarray(logits), jnp.asarray(seeds), -255)),
        rtol=LOSS_RTOL)


def test_seg_cam_and_minmax_match_jax():
    f = np.random.default_rng(4).standard_normal((2, 5, 6, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        ex.seg_cam(torch.from_numpy(f)).numpy(),
        np.asarray(jex.seg_cam(jnp.asarray(f))), atol=1e-7)
    c = f[..., 0]
    np.testing.assert_allclose(
        ex.normalize_minmax(torch.from_numpy(c)).numpy(),
        np.asarray(jex.normalize_minmax(jnp.asarray(c))), atol=1e-6)


@pytest.mark.parametrize("thresh", [None, 100.0])
def test_host_roi_all_matches_jax(thresh):
    rng = np.random.default_rng(5)
    for cam in (rng.random((16, 20)).astype(np.float32) ** 3,
                np.full((8, 8), 0.3, np.float32)):
        got = roi.roi_one_cam_np(cam, constants.ROI_ALL, thresh=thresh)
        want = jroi.roi_one_cam_np(cam, jconst.ROI_ALL, thresh=thresh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert otsu_np.otsu_np(np.floor(cam * 255)) == \
            jotsu_np.otsu_np(np.floor(cam * 255))


def test_loss_window_is_inclusive():
    loss = ElementaryLoss(start_ep=2, end_ep=4)
    assert [loss.is_on(e) for e in range(6)] == [False, False, True, True,
                                                  True, False]
    assert ElementaryLoss().is_on(10 ** 6)
