"""Port parity: the F-CAM modules — the five losses of losses/fcam.py,
get_loss_fcam, fcam_seeder, and UnetFCAM with the image-reconstruction
head.

Each loss's value and its gradients (with respect to the decoder logits,
and for the reconstruction also to the reconstruction) are held against
the JAX package (jax.value_and_grad) on the same numpy inputs from a
seed, in float32; the CRF term through the exact filter and the landmark
filter (both solvers).  fcam_seeder gets the Gumbel noise of the JAX
seeder's own key splits, so the seed masks must be equal.  UnetFCAM's
forward (im_recon included) runs on weights transplanted from flax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (assert_close, images, jax_model,
                                 jax_variables, torch_model)
from tcam_wsol_video_tpu.cams.seeding import FCAMSeederCfg as JFCfg
from tcam_wsol_video_tpu.cams.seeding import fcam_seeder as jfcam_seeder
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.losses import core as jcore
from tcam_wsol_video_tpu.losses import fcam as jfcam
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams.seeding import FCAMSeederCfg, fcam_seeder
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.losses import core as tcore
from tcam_wsol_video_tpu_torch.losses import fcam as tfcam
from tcam_wsol_video_tpu_torch.losses.build import get_loss, get_loss_fcam
from test_torch_seeding import jax_gumbel

torch.set_num_threads(1)

# fp32 softmax, logs and sums in another order; the CRF terms inherit the
# filters' relative error (test_torch_losses.py's bounds)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
# conv/BN chains in fp32, summed in another order (test_torch_models.py)
FWD_RTOL = 1e-4
ELB_T = 2.0
B, H, W = 4, 24, 24


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    fcams = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    seeds = rng.choice([0, 1, C.SEG_IGNORE_IDX], (B, H, W),
                       p=[0.1, 0.1, 0.8]).astype(np.int32)
    seeds[1] = C.SEG_IGNORE_IDX            # an image without seeds
    return {
        "fcams": fcams, "seeds": seeds,
        "raw_img": (rng.random((B, H, W, 3)) * 255).astype(np.float32),
        "x_in": rng.standard_normal((B, H, W, 3)).astype(np.float32),
        "im_recon": rng.random((B, H, W, 3)).astype(np.float32),
    }


CASES = {
    "self_learning": ("SelfLearningFcams", dict(lambda_=0.7)),
    "crf_exact": ("ConRanFieldFcams", dict(lambda_=2e-9)),
    "crf_scaled": ("ConRanFieldFcams", dict(lambda_=2e-9, sigma_rgb=10.0,
                                            sigma_xy=80.0,
                                            scale_factor=0.5)),
    "crf_landmarks": ("ConRanFieldFcams", dict(lambda_=2e-9,
                                               impl="landmarks",
                                               n_landmarks=128)),
    "entropy": ("EntropyFcams", dict(lambda_=0.5)),
    "max_size_positive": ("MaxSizePositiveFcams", dict(lambda_=0.01)),
    "img_reconstruction": ("ImgReconstruction", dict(lambda_=1.3)),
    "img_reconstruction_elb": ("ImgReconstruction", dict(lambda_=0.4,
                                                         use_elb=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fcam_loss_value_and_grad_match_jax(case):
    name, kw = CASES[case]
    jloss, tloss = getattr(jfcam, name)(**kw), getattr(tfcam, name)(**kw)
    assert tloss.__name__ == jloss.__name__
    x = _inputs(11)

    def jfn(fcams, im_recon):
        inputs = jcore.LossInputs(
            fcams=fcams, im_recon=im_recon, seeds=jnp.asarray(x["seeds"]),
            raw_img=jnp.asarray(x["raw_img"]), x_in=jnp.asarray(x["x_in"]))
        return jloss.compute(inputs, ELB_T)
    want, (want_g, want_gr) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x["fcams"]), jnp.asarray(x["im_recon"]))

    fcams = torch.from_numpy(x["fcams"]).requires_grad_(True)
    recon = torch.from_numpy(x["im_recon"]).requires_grad_(True)
    got = tloss.compute(tcore.LossInputs(
        fcams=fcams, im_recon=recon, seeds=torch.from_numpy(x["seeds"]),
        raw_img=torch.from_numpy(x["raw_img"]),
        x_in=torch.from_numpy(x["x_in"])), ELB_T)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    got.backward()
    for t, w in ((fcams, want_g), (recon, want_gr)):
        w = np.asarray(w)
        if not np.abs(w).max():
            assert t.grad is None or not t.grad.abs().max()
            continue
        assert (np.linalg.norm(t.grad.numpy() - w)
                <= GRAD_RTOL * np.linalg.norm(w)), case


def test_crf_term_with_the_lockstep_solver_matches_jax(monkeypatch):
    """TCAM_LMK_SOLVER=lockstep on both sides (read at call time)."""
    monkeypatch.setenv("TCAM_LMK_SOLVER", "lockstep")
    kw = dict(lambda_=2e-9, impl="landmarks", n_landmarks=512)
    jloss, tloss = jfcam.ConRanFieldFcams(**kw), tfcam.ConRanFieldFcams(**kw)
    x = _inputs(12)
    want = jloss.compute(jcore.LossInputs(
        fcams=jnp.asarray(x["fcams"]), raw_img=jnp.asarray(x["raw_img"])),
        ELB_T)
    got = tloss.compute(tcore.LossInputs(
        fcams=torch.from_numpy(x["fcams"]),
        raw_img=torch.from_numpy(x["raw_img"])), ELB_T)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_self_learning_numden_matches_jax():
    x = _inputs(13)
    kw = dict(lambda_=0.7)
    jnum, jden = jfcam.SelfLearningFcams(**kw).compute_numden(
        jcore.LossInputs(fcams=jnp.asarray(x["fcams"]),
                         seeds=jnp.asarray(x["seeds"])), ELB_T)
    loss = tfcam.SelfLearningFcams(**kw)
    inputs = tcore.LossInputs(fcams=torch.from_numpy(x["fcams"]),
                              seeds=torch.from_numpy(x["seeds"]))
    num, den = loss.compute_numden(inputs, ELB_T)
    np.testing.assert_allclose(num.item(), float(jnum), rtol=LOSS_RTOL)
    assert den.item() == float(jden)
    np.testing.assert_allclose((num / den).item(),
                               loss.compute(inputs, ELB_T).item(),
                               rtol=1e-6)


def _f_cl_flags(**kw) -> TCAMConfig:
    return TCAMConfig(task=C.F_CL, arch="UnetFCAM", im_rec=True,
                      im_rec_lambda=0.2, im_rec_elb=True, sl_fc=True,
                      sl_fc_lambda=0.5, sl_start_ep=1, crf_fc=True,
                      crf_lambda=3e-9, crf_sigma_rgb=10.0, crf_scale=0.5,
                      crf_end_ep=4, crf_impl="landmarks",
                      crf_n_landmarks=512, entropy_fc=True,
                      entropy_fc_lambda=0.3, max_sizepos_fc=True,
                      max_sizepos_fc_lambda=0.01,
                      max_sizepos_fc_start_ep=2).replace(**kw)


def test_get_loss_fcam_wires_the_terms_as_jax():
    targs = _f_cl_flags()
    cfg = get_config(C.YTOV1)
    cfg.update(targs.__dict__)
    jml = jget_loss(HParams(cfg))
    tml = get_loss(targs)
    assert ([l.__name__ for l in tml.losses]
            == [l.__name__ for l in jml.losses]
            == ["img_reconstruction", "self_learning_fcams",
                "con_ran_field_fcams", "entropy_fcams",
                "max_size_positive_fcams"])
    for tl, jl in zip(tml.losses, jml.losses):
        for attr in ("lambda_", "start_ep", "end_ep", "impl", "n_landmarks",
                     "rff_freqs", "sigma_rgb", "sigma_xy", "scale_factor",
                     "use_elb"):
            if hasattr(jl, attr):
                assert getattr(tl, attr) == getattr(jl, attr), (tl, attr)
    for epoch in (0, 1, 2, 5):
        assert tml.switches(epoch) == [float(v) for v in
                                       jml.switches(epoch)]
    with pytest.raises(ValueError, match="at least one loss"):
        get_loss_fcam(_f_cl_flags(im_rec=False, sl_fc=False, crf_fc=False,
                                  entropy_fc=False, max_sizepos_fc=False))


SEEDER_CASES = {
    "defaults": dict(),
    "no_erosion_dilated": dict(min_=5, max_=3, fg_erode_iter=0, ksz=3),
    "bisect_topk": dict(min_=40, max_=40, min_p=0.3, fg_erode_k=3),
    "no_bg": dict(min_=0, max_=4, fg_erode_k=3, ksz=2),
}


@pytest.mark.parametrize("case", sorted(SEEDER_CASES))
def test_fcam_seeder_masks_equal_with_injected_noise(case):
    kw = SEEDER_CASES[case]
    rng = np.random.default_rng(21)
    b, h, w = 4, 20, 24
    yy, xx = np.mgrid[:h, :w]
    cams = np.stack([np.exp(-((yy - rng.uniform(4, 16)) ** 2
                              + (xx - rng.uniform(4, 20)) ** 2)
                            / rng.uniform(20, 60)) for _ in range(b)])
    cams = (0.9 * cams + 0.1 * rng.random((b, h, w))).astype(np.float32)
    cams[3] = 0.5                   # constant: STOtsu keeps every pixel
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax.jit(lambda k, c: jfcam_seeder(k, c, JFCfg(**kw)))(
        key, jnp.asarray(cams)))
    got = fcam_seeder(torch.from_numpy(cams), FCAMSeederCfg(**kw),
                      gumbel=torch.from_numpy(jax_gumbel(key, b, h * w)))
    np.testing.assert_array_equal(got.numpy(), want)
    if kw.get("max_", 10):
        assert (want[:3] == 1).any()
    if kw.get("min_", 10):
        assert (want == 0).any()


def test_fcam_seeder_draws_from_generator():
    cams = torch.from_numpy(np.random.default_rng(22).random(
        (2, 16, 16)).astype(np.float32))
    cfg = FCAMSeederCfg(min_=3, max_=3, fg_erode_iter=0)
    a = fcam_seeder(cams, cfg, generator=torch.Generator().manual_seed(2))
    b = fcam_seeder(cams, cfg, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((a == 1).sum((1, 2)) > 0).all() and ((a == 0).sum((1, 2)) > 0).all()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_fcam_with_reconstruction_matches_jax(train):
    """UnetFCAM (= UnetTCAM) with im_rec and img_range 2: the transplant
    carries the reconstruction head; logits, fcams and im_recon agree."""
    jm = jax_model(freeze_cl=True, im_rec=True, img_range=2.0)
    variables = jax_variables(jm, seed=3)
    assert "reconstruction_head" in variables["params"]
    x = images(np.random.default_rng(5), 2)
    if train:
        want, _ = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables,
                                                                 x)
    tm = torch_model(variables, freeze_cl=True, im_rec=True, img_range=2.0)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("cl_logits", "fcams", "im_recon"):
        assert_close(got[k].numpy(), want[k], FWD_RTOL, k)
    assert 0.0 <= float(got["im_recon"].min()) <= float(
        got["im_recon"].max()) <= 2.0
    assert torch_model(jax_variables(jax_model(True), seed=3))(
        torch.from_numpy(x))["im_recon"] is None
