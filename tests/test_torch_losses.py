"""Port parity: the TCAM losses beyond the slice-1 recipe and their
assembly.

Each loss's value and its gradient with respect to the decoder logits
are held against the JAX package (jax.grad) on the same inputs, made with
numpy from a seed, in float32; the temporal joint CRF runs through the
exact filter and the landmark filter.  get_loss_tcam is held against the
JAX get_loss for the order and the names of the terms it wires (image
reconstruction included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.losses import core as jcore
from tcam_wsol_video_tpu.losses import tcam as jtcam
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.losses import core as tcore
from tcam_wsol_video_tpu_torch.losses import tcam as ttcam
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam

torch.set_num_threads(1)

# fp32 softmax, log and sums of up to 2 * 24 * 72 terms in another order;
# the CRF terms inherit the filters' relative error (test_torch_crf.py)
LOSS_RTOL = 1e-5
# gradients, relative L2 over the whole logits tensor
GRAD_RTOL = 1e-5
ELB_T = 2.0
B, H, W = 6, 24, 24


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "fcams": rng.standard_normal((B, H, W, 2)).astype(np.float32),
        "raw_img": (rng.random((B, H, W, 3)) * 255).astype(np.float32),
        "fg_size": rng.uniform(0.1, 0.6, B).astype(np.float32),
        "msk_bbox": (rng.random((B, H, W)) < 0.4).astype(np.float32),
    }


def _both(name: str, **kw):
    return getattr(jtcam, name)(**kw), getattr(ttcam, name)(**kw)


CASES = {
    "entropy": ("EntropyTcams", dict(lambda_=0.5)),
    "bg_size_great_size_fg": ("BgSizeGreatSizeFgTcams", dict(lambda_=0.7)),
    "fg_size": ("FgSizeTcams", dict(eps=0.01, lambda_=1.3)),
    "empty_outside_bbox": ("EmptyOutsideBboxTcams", dict(lambda_=0.9)),
    "max_size_positive": ("MaxSizePositiveTcams", dict(lambda_=0.01)),
    "rgb_joint_crf_exact": ("RgbJointConRanFieldTcams",
                            dict(clip_len=3, lambda_=2e-9, impl="exact")),
    "rgb_joint_crf_landmarks": ("RgbJointConRanFieldTcams",
                                dict(clip_len=3, lambda_=2e-9,
                                     impl="landmarks", n_landmarks=256)),
    "rgb_joint_crf_single_frame": ("RgbJointConRanFieldTcams",
                                   dict(clip_len=1, lambda_=2e-9)),
    "crf_landmarks": ("ConRanFieldTcams",
                      dict(lambda_=2e-9, impl="landmarks", n_landmarks=128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tcam_loss_value_and_grad_match_jax(case):
    name, kw = CASES[case]
    jloss, tloss = _both(name, **kw)
    x = _inputs(7)

    def jfn(fcams):
        inputs = jcore.LossInputs(fcams=fcams,
                                  raw_img=jnp.asarray(x["raw_img"]),
                                  fg_size=jnp.asarray(x["fg_size"]),
                                  msk_bbox=jnp.asarray(x["msk_bbox"]))
        return jloss.compute(inputs, ELB_T)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x["fcams"]))

    fcams = torch.from_numpy(x["fcams"]).requires_grad_(True)
    got = tloss.compute(tcore.LossInputs(
        fcams=fcams, raw_img=torch.from_numpy(x["raw_img"]),
        fg_size=torch.from_numpy(x["fg_size"]),
        msk_bbox=torch.from_numpy(x["msk_bbox"])), ELB_T)
    assert tloss.__name__ == jloss.__name__
    if case == "rgb_joint_crf_single_frame":
        assert got.item() == 0.0 == float(want)
        return
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    got.backward()
    g = fcams.grad.numpy()
    want_g = np.asarray(want_g)
    assert (np.linalg.norm(g - want_g)
            <= GRAD_RTOL * max(np.linalg.norm(want_g), 1e-30))


def test_rgb_joint_crf_refuses_partial_clips():
    loss = ttcam.RgbJointConRanFieldTcams(clip_len=4)
    x = _inputs(8)
    with pytest.raises(ValueError):
        loss.compute(tcore.LossInputs(
            fcams=torch.from_numpy(x["fcams"]),
            raw_img=torch.from_numpy(x["raw_img"])), ELB_T)


def test_one_channel_head_goes_through_sigmoid():
    x = np.random.default_rng(9).standard_normal((2, 4, 4, 1)).astype(
        np.float32)
    np.testing.assert_allclose(
        tcore.softmax_fcams(torch.from_numpy(x)).numpy(),
        np.asarray(jcore.softmax_fcams(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


def _all_flags(**kw) -> TCAMConfig:
    return TCAMConfig(task=C.TCAM, sl_tc=True, crf_tc=True,
                      crf_impl="landmarks", rgb_jcrf_tc=True, knn_tc=1,
                      max_sizepos_tc=True, size_bg_g_fg_tc=True,
                      sizefg_tmp_tc=True, empty_out_bb_tc=True,
                      rgb_jcrf_tc_lambda=3e-9, sizefg_tmp_tc_eps=0.02
                      ).replace(**kw)


def test_get_loss_tcam_wires_the_terms_as_jax():
    targs = _all_flags(crf_n_landmarks=512, crf_tc_start_ep=2,
                       empty_out_bb_tc_end_ep=4)
    cfg = get_config(C.YTOV1)
    cfg.update(targs.__dict__)
    jml = jget_loss(HParams(cfg))
    tml = get_loss_tcam(targs)
    assert ([l.__name__ for l in tml.losses]
            == [l.__name__ for l in jml.losses])
    for tl, jl in zip(tml.losses, jml.losses):
        for attr in ("lambda_", "start_ep", "end_ep", "impl", "n_landmarks",
                     "rff_freqs", "clip_len", "eps", "sigma_rgb",
                     "scale_factor"):
            if hasattr(jl, attr):
                assert getattr(tl, attr) == getattr(jl, attr), (tl, attr)
    for epoch in (0, 5):
        assert tml.switches(epoch) == [float(v) for v in
                                       jml.switches(epoch)]


def test_get_loss_tcam_refuses_what_it_cannot_build():
    # im_rec was refused before the reconstruction head was ported: it now
    # wires img_reconstruction first, with JAX's lambda and ELB switch
    targs = _all_flags(im_rec=True, im_rec_lambda=0.3, im_rec_elb=True)
    cfg = get_config(C.YTOV1)
    cfg.update(targs.__dict__)
    jml = jget_loss(HParams(cfg))
    tml = get_loss_tcam(targs)
    assert ([l.__name__ for l in tml.losses]
            == [l.__name__ for l in jml.losses])
    assert tml.losses[0].__name__ == "img_reconstruction"
    assert (tml.losses[0].lambda_, tml.losses[0].use_elb) == (
        jml.losses[0].lambda_, jml.losses[0].use_elb) == (0.3, True)
    with pytest.raises(ValueError):
        get_loss_tcam(_all_flags(knn_tc=0))
