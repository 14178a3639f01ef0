"""Port parity: TCAM without a CAM store, seed CAMs recomputed each step
from the frozen stage-1 classifier.

One step of the port (engine/steps.make_train_step with the classifier)
against the JAX step built with recompute_std_cams=True, from the same
transplanted weights (a small UnetTCAM, and a small STDClassifier of other
weights as the seeder) and the same batch, whose stored CAM and ROI are
the dataset's zeros; the port's seeder gets the JAX step's Gumbel noise.
Compared: the recomputed std_cam and the seeds as each seeder receives and
returns them, and every loss term.  Then the trainer and CLI: the
recompute branch is taken without a store (and only then), the stage-2
model's weights do not depend on the classifier, and the classifier is
read from the tcam_pretrained_seeder_ch_pt snapshot.  float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcam_wsol_video_tpu.engine.steps as jsteps_mod
import tcam_wsol_video_tpu_torch.engine.steps as tsteps_mod
from torch_port_fixtures import (CROP, assert_close, images, jax_classifier,
                                 jax_model, jax_variables, torch_classifier,
                                 torch_model)
from tcam_wsol_video_tpu.cams import extractors as jex
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.core.config import stage2_tcam_recipe
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
from test_torch_seeding import jax_gumbel

torch.set_num_threads(1)

# the classifier's CAMs: a conv/BN chain in fp32 summed in another order,
# min-max normalized, then resized (see test_torch_stage1); relative to
# the largest entry, which is 1
CAM_RTOL = 1e-4
# loss terms of the same network on the same seeds (see test_torch_step)
LOSS_RTOL = 1e-4
B = 2


def _recipe(use_roi: bool):
    # fp32 on both sides (the bf16 policy is held in test_torch_dtype.py)
    return stage2_tcam_recipe(crop_size=CROP, batch_size=B,
                              sl_tc_use_roi=use_roi,
                              compute_dtype="float32")


def _jax_args(targs):
    cfg = get_config(C.YTOV1)
    cfg.update(dict(targs.__dict__))
    return HParams(cfg)


def _batch(seed: int) -> dict:
    """A batch as the dataset gives it without a CAM store: the stored
    CAM and the ROI are zeros."""
    rng = np.random.default_rng(seed)
    return {
        "image": images(rng, B),
        "raw_img": (rng.random((B, CROP, CROP, 3)) * 255).astype(np.float32),
        "label": rng.integers(0, 10, B).astype(np.int32),
        "std_cam": np.zeros((B, CROP, CROP), np.float32),
        "roi": np.zeros((B, CROP, CROP), np.int32),
        "msk_bbox": np.ones((B, CROP, CROP), np.float32),
    }


def _step_both(use_roi: bool, monkeypatch) -> dict:
    targs = _recipe(use_roi)
    args = _jax_args(targs)
    jm = jax_model(freeze_cl=True)
    variables = jax_variables(jm, seed=1)
    jcls = jax_classifier()
    cls_vars = jax_variables(jcls, seed=5)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    scfg = JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)
    batch = _batch(3)
    key = jax.random.PRNGKey(11)

    # each seeder's input CAMs and output seeds, as the steps call it
    seen = {}
    jseeder = jsteps_mod.tcam_seeder

    def jspy(k, cams, cfg, roi=None, seed_tech=None):
        out = jseeder(k, cams, cfg, roi=roi, seed_tech=seed_tech)
        jax.debug.callback(
            lambda c, s: seen.__setitem__("jax", (np.asarray(c),
                                                  np.asarray(s))),
            cams, out)
        return out

    tseeder = tsteps_mod.tcam_seeder

    def tspy(cams, cfg, **kw):
        out = tseeder(cams, cfg, **kw)
        seen["port"] = (cams.detach().clone().numpy(), out.numpy())
        return out

    monkeypatch.setattr(jsteps_mod, "tcam_seeder", jspy)
    monkeypatch.setattr(tsteps_mod, "tcam_seeder", tspy)

    _, jmet = jstep(jm, ml, opt, args, scfg, classifier_model=jcls,
                    recompute_std_cams=True)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), key, jnp.float32(1.0),
        cls_vars["params"], cls_vars["batch_stats"])
    jax.effects_barrier()

    tm = torch_model(variables, freeze_cl=True)
    tcls = torch_classifier(cls_vars).eval().requires_grad_(False)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss_tcam(targs)
    k_seed, _ = jax.random.split(key)
    gumbel = torch.from_numpy(jax_gumbel(k_seed, B, CROP * CROP))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["label"] = tbatch["label"].long()
    tmet = make_train_step(tml, targs, seeder_cfg_from_args(targs),
                           classifier_model=tcls)(
        tstate, tbatch, tml.switches(0), True, gumbel=gumbel)
    return dict(jmet=jmet, tmet=tmet, seen=seen, batch=tbatch, tcls=tcls)


@pytest.fixture(scope="module")
def stepped():
    with pytest.MonkeyPatch.context() as mp:
        return _step_both(False, mp)


@pytest.fixture(scope="module")
def stepped_roi():
    with pytest.MonkeyPatch.context() as mp:
        return _step_both(True, mp)


def test_recomputed_std_cam_matches(stepped):
    tcam, _ = stepped["seen"]["port"]
    jcam, _ = stepped["seen"]["jax"]
    assert tcam.shape == (B, CROP, CROP)
    assert_close(tcam, jcam, CAM_RTOL, "std_cam")
    # the classifier's CAMs, not the batch's zeros, reach the seeder
    assert tcam.min() >= 0.0 and tcam.max() <= 1.0
    assert all(tcam[i].max() > 0.5 for i in range(B))
    assert float(stepped["batch"]["std_cam"].abs().max()) == 0.0


def test_recomputed_seeds_match(stepped):
    tseeds = stepped["seen"]["port"][1]
    jseeds = stepped["seen"]["jax"][1]
    np.testing.assert_array_equal(tseeds, jseeds)
    assert (tseeds == 1).any() and (tseeds == 0).any()


@pytest.mark.parametrize("term", ["loss", "self_learning_tcams",
                                  "con_ran_field_tcams",
                                  "max_size_positive_tcams"])
def test_recompute_step_loss_terms_match(stepped, term):
    got = float(stepped["tmet"][term])
    want = float(stepped["jmet"][term])
    assert abs(got - want) <= LOSS_RTOL * abs(want), (term, got, want)


def test_zero_roi_draws_no_foreground_seed(stepped_roi):
    """Without a store the dataset's ROI is all zero (JAX
    data/dataset.py), so under sl_tc_use_roi neither seeder draws a
    foreground seed: a behaviour of the reference, kept."""
    tcam, tseeds = stepped_roi["seen"]["port"]
    jcam, jseeds = stepped_roi["seen"]["jax"]
    assert_close(tcam, jcam, CAM_RTOL, "std_cam")
    np.testing.assert_array_equal(tseeds, jseeds)
    assert not (tseeds == 1).any() and not (jseeds == 1).any()
    assert (tseeds == 0).any()
    for term in ("loss", "self_learning_tcams"):
        got = float(stepped_roi["tmet"][term])
        want = float(stepped_roi["jmet"][term])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (term, got, want)


@pytest.mark.parametrize("support_background", [False, True],
                         ids=["plain", "support_background"])
def test_cam_fc_weights_clamps_as_jax(support_background):
    """The WGAP head has no background row: with support_background the
    last label reads past the fc weights, and both sides read its last
    row (JAX's gather clamps)."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    fc = rng.standard_normal((8, 10)).astype(np.float32)       # flax (C, K)
    labels = np.array([9, 0, 4], np.int32)
    want = jex.cam_fc_weights(jnp.asarray(feats), jnp.asarray(fc),
                              jnp.asarray(labels), support_background)
    got = ex.cam_fc_weights(torch.from_numpy(feats).permute(0, 3, 1, 2),
                            torch.from_numpy(fc.T.copy()),
                            torch.from_numpy(labels), support_background)
    assert_close(got.numpy(), want, CAM_RTOL, "cam")


def test_recompute_needs_tcam_with_sl_tc():
    cls = torch_classifier(jax_variables(jax_classifier(), seed=5))
    targs = _recipe(False)
    with pytest.raises(ValueError):
        make_train_step(get_loss_tcam(targs.replace(sl_tc=False)),
                        targs.replace(sl_tc=False), None,
                        classifier_model=cls)
