"""Port parity: the train steps of this slice against JAX make_train_step,
and the trainer's epoch switch.

- One F_CL step (UnetFCAM with the reconstruction head; self-learning,
  exact CRF, entropy, size prior and image reconstruction; seeds from the
  TCAM seeder and its sl_tc_* keys, as the JAX step draws them), then the
  F_CL eval CAM step; at float32, and the same step at bfloat16 against
  the JAX model built at bf16.
- One TCAM step of the recipe with im_rec, at float32.
- One TCAM step with the student seed source (JAX
  make_train_step(..., student_seed_source=True)): the best student's
  maps, ROI_LARGEST ROI, box mask and fg size replace the batch's; the
  student has its own weights and BN statistics.
- The trainer's switch engages only for TCAM, from
  sl_tc_epoch_switch_to_sl on, only with a best-localization snapshot,
  and reloads the student only when the best epoch changes; cli.train
  records each epoch's seed source.

Both packages start from the same transplanted weights (a small U-Net),
the same batch, and the port's seeder gets the JAX step's Gumbel noise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcam_wsol_video_tpu.engine.steps as jsteps_mod
import tcam_wsol_video_tpu_torch.engine.steps as tsteps_mod
from torch_port_fixtures import (CROP, assert_close, images, jax_model,
                                 jax_variables, torch_model)
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_cam_eval_step as jeval
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import (TCAMConfig, parse_args,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import (make_cam_eval_step,
                                                    make_train_step)
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict
from test_torch_dtype import _check_step
from test_torch_seeding import jax_gumbel
from test_torch_step import _check_updates
from test_torch_trainer import _flags, synth  # noqa: F401 (fixture)

torch.set_num_threads(1)

# loss terms of the same network on the same seeds at fp32 (as
# test_torch_step)
LOSS_RTOL = 1e-4
# the student's maps (a conv/BN chain in fp32, softmax, min-max), relative
# to their largest entry, which is 1; its fg size (a mean of them)
CAM_RTOL = 1e-4
B = 2


def _f_cl(**kw) -> TCAMConfig:
    """F_CL with every loss (exact CRF), seeds from the sl_tc_* seeder
    inside the ROI, fp32 unless kw says otherwise."""
    return TCAMConfig(
        task=C.F_CL, arch=C.UNETFCAM, crop_size=CROP, batch_size=B, lr=0.01,
        freeze_cl=True, compute_dtype="float32", im_rec=True,
        im_rec_lambda=0.5, sl_fc=True, sl_fc_lambda=1.0, crf_fc=True,
        crf_lambda=2e-9, entropy_fc=True, entropy_fc_lambda=0.1,
        max_sizepos_fc=True, max_sizepos_fc_lambda=0.01, sl_tc_min=2,
        sl_tc_max=2, sl_tc_ksz=3, sl_tc_min_p=0.1, sl_tc_max_p=0.6,
        sl_tc_seed_tech=C.SEED_WEIGHTED, sl_tc_use_roi=True).replace(**kw)


def _jax_args(targs) -> HParams:
    cfg = get_config(JC.YTOV1)
    cfg.update(dict(targs.__dict__))
    return HParams(cfg)


def _jax_seeder_cfg(args) -> JCfg:
    return JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cam = rng.random((B, CROP, CROP)).astype(np.float32) ** 2
    roi = np.stack([roi_one_cam_np(c)[0] for c in cam])
    return {
        "image": images(rng, B),
        "raw_img": (rng.random((B, CROP, CROP, 3)) * 255).astype(np.float32),
        "label": rng.integers(0, 10, B).astype(np.int32),
        "std_cam": cam, "roi": roi.astype(np.int32),
        "msk_bbox": np.ones((B, CROP, CROP), np.float32),
        "fg_size": rng.uniform(0.1, 0.5, B).astype(np.float32),
    }


def _step_both(targs, student_seed: int = None, monkeypatch=None) -> dict:
    """One JAX step and one port step from the same state under `targs`
    (with the student seed source when student_seed gives the student's
    weights), then each package's eval step at fp32."""
    jdtype = jnp.bfloat16 if targs.compute_dtype == "bfloat16" \
        else jnp.float32
    args = _jax_args(targs)
    im_rec = targs.im_rec
    variables = jax_variables(jax_model(True, im_rec=im_rec), seed=1)
    jm = jax_model(True, dtype=jdtype, im_rec=im_rec)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    batch = _batch(4)
    key = jax.random.PRNGKey(13)
    seen = {}
    extra, tkw = (), {}
    if student_seed is not None:
        svars = jax_variables(jax_model(True, im_rec=im_rec),
                              seed=student_seed)
        extra = (svars["params"], svars["batch_stats"])
        tkw = {"student": torch_model(svars, True, im_rec=im_rec)}
        jseeder, tseeder = jsteps_mod.tcam_seeder, tsteps_mod.tcam_seeder

        def jspy(k, cams, cfg, roi=None, seed_tech=None):
            out = jseeder(k, cams, cfg, roi=roi, seed_tech=seed_tech)
            jax.debug.callback(lambda c, r, s: seen.__setitem__(
                "jax", [np.asarray(v) for v in (c, r, s)]), cams, roi, out)
            return out

        def tspy(cams, cfg, roi=None, **kw):
            out = tseeder(cams, cfg, roi=roi, **kw)
            seen["port"] = [v.detach().clone().numpy()
                            for v in (cams, roi, out)]
            return out

        monkeypatch.setattr(jsteps_mod, "tcam_seeder", jspy)
        monkeypatch.setattr(tsteps_mod, "tcam_seeder", tspy)
    new_jstate, jmet = jstep(jm, ml, opt, args, _jax_seeder_cfg(args),
                             student_seed_source=student_seed is not None)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), key, jnp.float32(1.0), *extra)
    jax.effects_barrier()
    jcams, _ = jeval(jax_model(True, im_rec=im_rec), args)(
        new_jstate.params, new_jstate.batch_stats,
        jnp.asarray(batch["image"]), jnp.asarray(batch["label"]), key)

    tm = torch_model(variables, True, im_rec=im_rec)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    k_seed, _ = jax.random.split(key)
    gumbel = torch.from_numpy(jax_gumbel(k_seed, B, CROP * CROP))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["label"] = tbatch["label"].long()
    tmet = make_train_step(tml, targs, seeder_cfg_from_args(targs))(
        tstate, tbatch, tml.switches(0), True, gumbel=gumbel, **tkw)
    tcams, _ = make_cam_eval_step(tm, targs)(tbatch["image"])
    return dict(variables=variables, old=flax_to_state_dict(variables),
                jstate=new_jstate, jmet=jmet, tmet=tmet, tm=tm,
                new=flax_to_state_dict(jax.tree_util.tree_map(
                    np.asarray, {"params": new_jstate.params,
                                 "batch_stats": new_jstate.batch_stats})),
                jcams=np.asarray(jcams), tcams=tcams.numpy(), seen=seen)


def _check_terms(stepped, names):
    assert set(names) <= set(stepped["tmet"])
    for term in ["loss"] + names:
        got = float(stepped["tmet"][term])
        want = float(stepped["jmet"][term])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (term, got, want)


F_CL_TERMS = ["img_reconstruction", "self_learning_fcams",
              "con_ran_field_fcams", "entropy_fcams",
              "max_size_positive_fcams"]


@pytest.fixture(scope="module")
def f_cl_fp32():
    return _step_both(_f_cl())


def test_f_cl_step_matches_jax(f_cl_fp32):
    _check_terms(f_cl_fp32, F_CL_TERMS)
    _check_updates(f_cl_fp32)


def test_f_cl_eval_cams_match_jax(f_cl_fp32):
    assert_close(f_cl_fp32["tcams"], f_cl_fp32["jcams"], 1e-4, "cams")


def test_f_cl_step_matches_jax_at_bf16():
    stepped = _step_both(_f_cl(compute_dtype="bfloat16"))
    assert set(F_CL_TERMS) <= set(stepped["tmet"])
    _check_step(stepped, frozen_prefixes=("encoder.",
                                          "classification_head."))


def test_tcam_step_with_im_rec_matches_jax():
    targs = stage2_tcam_recipe(crop_size=CROP, batch_size=B,
                               compute_dtype="float32", im_rec=True,
                               im_rec_lambda=0.3)
    stepped = _step_both(targs)
    _check_terms(stepped, ["img_reconstruction", "self_learning_tcams",
                           "con_ran_field_tcams", "max_size_positive_tcams"])
    _check_updates(stepped)


def test_student_seed_step_matches_jax(monkeypatch):
    """The student's maps, its ROI_LARGEST ROI, box mask and fg size reach
    the seeder and the losses as in JAX (empty_out_bb_tc reads the box
    mask, sizefg_tmp_tc the fg size)."""
    targs = stage2_tcam_recipe(
        crop_size=CROP, batch_size=B, compute_dtype="float32",
        sl_tc_epoch_switch_to_sl=1, empty_out_bb_tc=True,
        sizefg_tmp_tc=True, sizefg_tmp_tc_eps=0.05)
    stepped = _step_both(targs, student_seed=7, monkeypatch=monkeypatch)
    (jc, jr, js), (tc, tr, ts) = stepped["seen"]["jax"], \
        stepped["seen"]["port"]
    assert_close(tc, jc, CAM_RTOL, "student cams")
    assert tc.max() == 1.0 and tc.min() == 0.0
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ts, js)
    assert (jr.sum((1, 2)) < CROP * CROP).any()   # ROI_LARGEST, not all
    _check_terms(stepped, ["self_learning_tcams", "con_ran_field_tcams",
                           "max_size_positive_tcams", "fg_size_tcams",
                           "empty_outside_bbox_tcams"])
    _check_updates(stepped)


# ---------------------------------------------------------- epoch switch
def _switch_trainer(root, outd, task=C.TCAM, switch=2):
    flags = _flags(root, outd, 1) + ["--sl_tc_epoch_switch_to_sl",
                                     str(switch)]
    if task == C.F_CL:
        flags = flags[:1] + [C.F_CL, "--arch", C.UNETFCAM] + flags[4:] + [
            "--sl_fc", "true"]
    args, _ = parse_args(flags)
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, "cpu")
    torch.manual_seed(0)
    model = cli_train.create_model_from_args(args, device="cpu")
    return Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                   device="cpu")


def _snapshot(trainer, epoch, scale):
    """A best-localization snapshot at `epoch`: the model's weights
    scaled, so that each snapshot differs."""
    trainer.meters["val_localization"].update(float(epoch + 1), epoch)
    trainer.best_loc_state = {k: (v * scale if v.is_floating_point() else v)
                              for k, v in trainer.model.state_dict().items()}


def test_trainer_switch_engages_and_reloads_as_jax(synth, tmp_path):
    tr = _switch_trainer(synth, str(tmp_path), switch=2)
    assert not tr._student_for(3)           # no snapshot yet
    _snapshot(tr, 0, 1.5)
    assert not tr._student_for(1)           # before the switch epoch
    assert tr._student is None
    assert tr._student_for(2) and tr.student_reloads == 1
    student = tr._student
    w = "segmentation_head.conv.weight"
    assert torch.equal(student.state_dict()[w], tr.best_loc_state[w])
    assert not any(p.requires_grad for p in student.parameters())
    assert tr._student_for(3) and tr.student_reloads == 1   # same best
    _snapshot(tr, 3, 2.0)
    assert tr._student_for(4) and tr.student_reloads == 2
    assert tr._student is student
    assert torch.equal(student.state_dict()[w], tr.best_loc_state[w])
    for kw in (dict(switch=-1), dict(task=C.F_CL)):
        other = _switch_trainer(synth, str(tmp_path / "o"), **kw)
        _snapshot(other, 0, 1.0)
        assert not other._student_for(5)


def test_cli_train_switches_the_seed_source(synth, tmp_path):
    flags = _flags(synth, str(tmp_path), 3) + [
        "--sl_tc_epoch_switch_to_sl", "1", "--im_rec", "true",
        "--device", "cpu"]
    out = cli_train.main(flags)
    train = out["records"]["train"]
    assert [r["seed_source"] for r in train] == ["batch", "student",
                                                 "student"]
    assert train[1]["student_reloads"] == 1
    assert sum(r["student_reloads"] for r in train) >= 1
    assert all(np.isfinite(r["loss"]) for r in train)
    assert os.path.isfile(os.path.join(out["outd"], "passed.txt"))
