"""Port parity at the JAX default dtype policy: bf16 train steps, the
dump and the seeder classifier at compute_dtype, evaluation at
eval_compute_dtype (fp32).

The JAX models are built at compute_dtype="bfloat16" and both sides start
from the same transplanted fp32 parameters.  Two bf16 networks that sum
in another order round some activations to the neighbouring bf16 value
(2^-8 relative), and those flips grow through the layers; so the
forward, the losses and the updates are held at tolerances stated in
bf16 steps.  The size prior's `area` and the fp32 eval are held bit for
bit.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CROP, LAYERS, assert_close, images,
                                 jax_classifier, jax_model, jax_variables,
                                 torch_classifier, torch_model)
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.cli import dump_cams as jdump
from tcam_wsol_video_tpu.core import checkpoint as jckpt
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu.losses.tcam import \
    MaxSizePositiveTcams as JMaxSizePositive
from tcam_wsol_video_tpu.models.factory import _DTYPES as JDTYPES
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.cli import dump_cams
from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core.config import (COMPUTE_DTYPES,
                                                   TCAMConfig, parse_args,
                                                   stage1_cam_recipe,
                                                   stage2_tcam_production,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.synthetic import (make_stand_in_cam_store,
                                                      make_synthetic_dataset)
from tcam_wsol_video_tpu_torch.engine import evaluator
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.losses.tcam import (MaxSizePositiveTcams,
                                                   _areas)
from tcam_wsol_video_tpu_torch.models import factory, resnet
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict
from test_torch_seeding import jax_gumbel
from test_torch_step import _batch as tcam_batch

torch.set_num_threads(1)

BF16_EPS = 2.0 ** -8
# forward outputs relative to the largest value: the flips grow through
# the ~20 layers of the small networks to ~6 bf16 steps in train mode
# (measured 2.2e-2 for the fcams, 1.5e-2 for the last feature; eval mode
# 1.0e-2), 12 steps
FWD_RTOL = 12 * BF16_EPS
# BN running statistics after one train forward: fp32 statistics of
# inputs that differ by those flips (measured 1.2e-3), one step
BN_RTOL = BF16_EPS
B = 2


def _jax_args(targs) -> HParams:
    """JAX's config of the port's `targs` (the same compute dtypes)."""
    cfg = get_config(C.YTOV1)
    cfg.update(dict(targs.__dict__))
    return HParams(cfg)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ config
def test_config_dtype_defaults_and_choices_match_jax():
    ref = get_config(C.YTOV1)
    cfg = TCAMConfig()
    assert (cfg.compute_dtype, cfg.eval_compute_dtype) == (
        ref["compute_dtype"], ref["eval_compute_dtype"]) == (
        "bfloat16", "float32")
    assert set(COMPUTE_DTYPES) == set(JDTYPES) == set(factory.DTYPES)
    args, _ = parse_args(["--compute_dtype", "float32"])
    assert (args.compute_dtype, args.eval_compute_dtype) == (
        "float32", "float32")
    args, _ = parse_args(["--eval_compute_dtype", "bfloat16"])
    assert (args.compute_dtype, args.eval_compute_dtype) == (
        "bfloat16", "bfloat16")
    for flag in ("--compute_dtype", "--eval_compute_dtype"):
        with pytest.raises(ValueError, match="float32"):
            parse_args([flag, "float16"])


# ----------------------------------------------------------------- forward
@pytest.fixture(scope="module")
def forward_inputs():
    rng = np.random.default_rng(0)
    unet_vars = jax_variables(jax_model(freeze_cl=False), seed=3)
    cls_vars = jax_variables(jax_classifier(), seed=4)
    return images(rng, B), unet_vars, cls_vars


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ["unet", "classifier"])
def test_forward_matches_jax_at_bf16(forward_inputs, arch, train):
    x, unet_vars, cls_vars = forward_inputs
    if arch == "unet":
        jm, variables = jax_model(False, jnp.bfloat16), unet_vars
        tm = torch_model(variables, freeze_cl=False)
    else:
        jm, variables = jax_classifier(jnp.bfloat16), cls_vars
        tm = torch_classifier(variables)
    if train:
        jout, upd = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        jout = jm.apply(variables, jnp.asarray(x), train=False)
    tm.train(train)
    with torch.no_grad():
        tout = tm(torch.from_numpy(x), torch.bfloat16)

    keys = ["cl_logits"] + (["fcams"] if arch == "unet" else [])
    for k in keys:
        assert tout[k].dtype == torch.bfloat16, k
        assert jout[k].dtype == jnp.bfloat16, k
        assert_close(tout[k].float().numpy(), _f32(jout[k]), FWD_RTOL, k)
    for tf, jf in zip(tout["features"][1:], jout["features"][1:]):
        assert tf.dtype == torch.bfloat16 and jf.dtype == jnp.bfloat16
    assert_close(_nhwc(tout["features"][-1]), _f32(jout["features"][-1]),
                 FWD_RTOL, "last feature")
    # the input feature stays as given, on both sides
    assert tout["features"][0].dtype == torch.float32
    assert jout["features"][0].dtype == jnp.float32
    # fp32 parameters and running statistics
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    if train:
        new = flax_to_state_dict({"params": variables["params"],
                                  "batch_stats": jax.tree_util.tree_map(
                                      np.asarray, upd["batch_stats"])})
        sd = tm.state_dict()
        n = 0
        for k, want in new.items():
            if "running_" in k:
                assert sd[k].dtype == torch.float32
                assert_close(sd[k].numpy(), want, BN_RTOL, k)
                n += 1
        assert n > 0


# ------------------------------------------------------------------- steps
def _jax_tcam_step(targs, variables, batch, key):
    args = _jax_args(targs)
    jm = jax_model(freeze_cl=True, dtype=jnp.bfloat16)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    scfg = JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)
    return jstep(jm, ml, opt, args, scfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), key, jnp.float32(1.0))


def _tcam_step_both(targs) -> dict:
    """One JAX TCAM step (model at bf16) and one port step at the port's
    default compute dtype, from the same state, batch and seeder noise."""
    assert targs.compute_dtype == "bfloat16"
    variables = jax_variables(jax_model(freeze_cl=True), seed=1)
    batch = tcam_batch(2)
    key = jax.random.PRNGKey(9)
    new_jstate, jmet = _jax_tcam_step(targs, variables, batch, key)

    tm = torch_model(variables, freeze_cl=True)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    k_seed, _ = jax.random.split(key)
    gumbel = torch.from_numpy(jax_gumbel(k_seed, B, CROP * CROP))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["label"] = tbatch["label"].long()
    tmet = make_train_step(tml, targs, seeder_cfg_from_args(targs))(
        tstate, tbatch, tml.switches(0), True, gumbel=gumbel)
    return dict(old=flax_to_state_dict(variables), jmet=jmet, tmet=tmet,
                new=flax_to_state_dict(jax.tree_util.tree_map(
                    np.asarray, {"params": new_jstate.params,
                                 "batch_stats": new_jstate.batch_stats})),
                tm=tm)


@pytest.fixture(scope="module")
def tcam_exact():
    return _tcam_step_both(stage2_tcam_recipe(crop_size=CROP, batch_size=B))


@pytest.fixture(scope="module")
def tcam_landmarks():
    """The production recipe (landmark CRF; 256 landmarks on 32 x 32)."""
    return _tcam_step_both(stage2_tcam_production(
        crop_size=CROP, batch_size=B, crf_n_landmarks=256))


@pytest.fixture(scope="module")
def std_cl():
    """One JAX STD_CL step (classifier at bf16) and one port step at the
    port's default compute dtype."""
    targs = stage1_cam_recipe(crop_size=CROP, batch_size=3, lr=0.01)
    assert targs.compute_dtype == "bfloat16"
    args = _jax_args(targs)
    variables = jax_variables(jax_classifier(), seed=5)
    jm = jax_classifier(jnp.bfloat16)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    rng = np.random.default_rng(6)
    batch = {"image": images(rng, 3),
             "label": rng.integers(0, 10, 3).astype(np.int32)}
    new_jstate, jmet = jstep(jm, ml, opt, args)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), jax.random.PRNGKey(2), jnp.float32(0.0))

    tm = torch_classifier(variables)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    tbatch = {"image": torch.from_numpy(batch["image"]),
              "label": torch.from_numpy(batch["label"]).long()}
    tmet = make_train_step(tml, targs)(tstate, tbatch, tml.switches(0),
                                       False)
    return dict(old=flax_to_state_dict(variables), jmet=jmet, tmet=tmet,
                new=flax_to_state_dict(jax.tree_util.tree_map(
                    np.asarray, {"params": new_jstate.params,
                                 "batch_stats": new_jstate.batch_stats})),
                tm=tm)


def _terms(stepped):
    return {k: (float(stepped["tmet"][k]), float(stepped["jmet"][k]))
            for k in stepped["tmet"] if k not in ("n", "n_correct")}


def _update_errs(stepped):
    """Per tensor: |port update - JAX update| / max |JAX update| (the
    running statistics: relative to their largest entry)."""
    old, new = stepped["old"], stepped["new"]
    sd = stepped["tm"].state_dict()
    errs = {}
    for k, want in new.items():
        got = sd[k].numpy()
        assert sd[k].dtype == torch.float32, k
        if "running_" in k:
            errs[k] = np.abs(got - want).max() / np.abs(want).max()
            continue
        d_got, d_want = got - old[k], want - old[k]
        scale = np.abs(d_want).max()
        errs[k] = np.abs(d_got - d_want).max() / scale if scale else \
            float(np.abs(d_got).max())
    return errs


# each loss term relative to JAX's: the bf16 fcams enter the losses, which
# cast to fp32 where JAX's do (measured 2.5e-3 at most), two bf16 steps
LOSS_RTOL = 2 * BF16_EPS
# the trained parameters' updates, all tensors together, relative to the
# largest JAX update, in max norm and in L2 norm: at this size a bf16
# step's gradients are noisy in themselves (BN batch statistics over B =
# 2 small maps): JAX's own bf16 update is 0.23 (max) / 0.29 (L2) away from
# its fp32 update, the port's 0.28 / 0.32; the port's bf16 update is
# 0.05-0.35 / 0.15-0.34 away from JAX's
UPDATE_FRAC = 0.6
# the BN running statistics after the step, relative to their largest
# entry (measured 3.0e-3 for STD_CL), two bf16 steps
STEP_BN_RTOL = 2 * BF16_EPS
# frozen tensors (the encoder and head under freeze_cl) take optax's
# weight decay alone: as in test_torch_step
DELTA_RTOL = 2e-3
DELTA_ULPS = 4


def _check_step(stepped, frozen_prefixes=()):
    for k, (got, want) in _terms(stepped).items():
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
        assert stepped["tmet"][k].dtype == torch.float32, k
    old, new = stepped["old"], stepped["new"]
    sd = {k: v.numpy() for k, v in stepped["tm"].state_dict().items()}
    trained = []
    for k, want in new.items():
        assert sd[k].dtype == np.float32, k
        if "running_" in k:
            assert_close(sd[k], want, STEP_BN_RTOL, k)
        elif k.startswith(frozen_prefixes):
            d_got, d_want = sd[k] - old[k], want - old[k]
            tol = (DELTA_RTOL * np.abs(d_want).max() + DELTA_ULPS
                   * np.finfo(np.float32).eps * np.abs(old[k]).max())
            assert np.abs(d_got - d_want).max() <= tol, k
        else:
            trained.append(k)
    d_got = np.concatenate([(sd[k] - old[k]).ravel() for k in trained])
    d_want = np.concatenate([(new[k] - old[k]).ravel() for k in trained])
    assert np.abs(d_want).max() > 0
    assert np.abs(d_got - d_want).max() <= \
        UPDATE_FRAC * np.abs(d_want).max()
    assert np.linalg.norm(d_got - d_want) <= \
        UPDATE_FRAC * np.linalg.norm(d_want)
    # momentum and gradients stay fp32
    opt = stepped["tm"]
    for p in opt.parameters():
        assert p.grad is None or p.grad.dtype == torch.float32


def test_std_cl_step_matches_jax_at_bf16(std_cl):
    _check_step(std_cl)


def test_tcam_step_matches_jax_at_bf16(tcam_exact):
    _check_step(tcam_exact, ("encoder.", "classification_head."))


def test_tcam_landmarks_step_matches_jax_at_bf16(tcam_landmarks):
    _check_step(tcam_landmarks, ("encoder.", "classification_head."))


# -------------------------------------------------------------- size prior
def test_size_prior_area_is_jax_bf16_bit_for_bit():
    """The size prior sums the bf16 probabilities into a bf16 area (JAX
    losses/tcam.py: jnp.sum of bf16 accumulates in fp32 and rounds once):
    at 224^2 the area moves in steps of 128 or 256 pixels before the ELB
    casts it to fp32.  The same bf16 probabilities give the same bits on
    both sides, and the same loss."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 224, 224, 2)).astype(np.float32) * 2
    fcams = jnp.asarray(logits).astype(jnp.bfloat16)
    probs = jax.nn.softmax(fcams, axis=-1)
    tprobs = torch.from_numpy(_f32(probs).copy()).to(torch.bfloat16)
    assert np.array_equal(tprobs.float().numpy(), _f32(probs))
    for c in (0, 1):
        want = jnp.sum(probs[..., c].reshape(2, -1), axis=-1)
        got = _areas(tprobs, c)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert np.array_equal(got.float().numpy(), _f32(want)), c
        # bf16 steps of the area: 128 pixels in [16384, 32768)
        assert np.all(np.mod(got.float().numpy(), 128) == 0)

    jloss = JMaxSizePositive(lambda_=0.01).compute(
        type("I", (), {"fcams": fcams})(), 1.5)
    tloss = MaxSizePositiveTcams(lambda_=0.01).compute(
        type("I", (), {"fcams": torch.from_numpy(logits).to(
            torch.bfloat16)})(), 1.5)
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))


# -------------------------------------------------------------------- dump
# the stored CAMs (min-max normalized at the last feature's 4 x 4, then
# upsampled to 28) of the two packages' bf16 classifiers: the flips of
# the last feature after the normalization (measured 2.7e-2 at most,
# 1.4e-2 median), 12 bf16 steps
DUMP_CAM_ATOL = 12 * BF16_EPS
# a stored threshold moves with the CAM by a few Otsu bins of 1/255
# (measured 3)
DUMP_THRESH_ATOL = 6.0 / 255.0


@contextlib.contextmanager
def conv_weight_dtypes():
    """The dtypes of the weights that the port's convolutions compute
    with inside the block."""
    seen = set()
    orig = resnet.Conv2d._conv_forward

    def spy(self, x, weight, bias):
        seen.add(weight.dtype)
        assert x.dtype == weight.dtype
        return orig(self, x, weight, bias)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet.Conv2d, "_conv_forward", spy)
        yield seen


@pytest.fixture(scope="module")
def dumped_bf16(tmp_path_factory):
    """Each package's dump at its default compute dtype (bfloat16) of the
    same small classifier's snapshot, on a 48-frame synthetic set."""
    root = str(tmp_path_factory.mktemp("dump_bf16"))
    out = make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    variables = jax_variables(jax_classifier(), seed=11)
    jexp, texp = os.path.join(root, "jexp"), os.path.join(root, "texp")
    jckpt.save_best_model(os.path.join(jexp, C.BEST_LOC), 7, variables)
    ckpt.save_best_model(os.path.join(texp, C.BEST_LOC), 7,
                         torch_classifier(variables))
    cfg = get_config(C.YTOV1)
    cfg.update(dict(stage1_cam_recipe(
        crop_size=CROP, data_root=root,
        metadata_root=out["metadata_root"]).__dict__))
    assert cfg["compute_dtype"] == "bfloat16"
    with pytest.MonkeyPatch.context() as mp:
        # the JAX dump builds its model at the config's compute dtype
        mp.setattr(jdump, "create_model_from_args",
                   lambda a, **k: jax_classifier(JDTYPES[a.compute_dtype]))
        mp.setattr(dump_cams, "create_model_from_args",
                   lambda *a, **k: STDClassifier(
                       resnet.ResNetWSOL(layers=LAYERS), "WGAP", 10))
        jdump.dump_cams(HParams(cfg), jexp, os.path.join(root, "jstore"))
        with conv_weight_dtypes() as seen:
            dump_cams.main([
                "--task", "STD_CL", "--data_root", root, "--metadata_root",
                out["metadata_root"], "--crop_size", str(CROP), "--exp_dir",
                texp, "--out", os.path.join(root, "tstore"), "--device",
                "cpu"])
    return {"jstore": CamStore(os.path.join(root, "jstore")),
            "tstore": CamStore(os.path.join(root, "tstore")),
            "conv_dtypes": seen}


def test_dump_runs_at_bf16_and_matches_jax(dumped_bf16):
    assert dumped_bf16["conv_dtypes"] == {torch.bfloat16}
    jstore, tstore = dumped_bf16["jstore"], dumped_bf16["tstore"]
    assert set(tstore.thresholds) == set(jstore.thresholds)
    assert len(tstore.thresholds) == 48
    errs = []
    for fid, want_t in jstore.thresholds.items():
        got = tstore.load_cam(fid)
        assert got.dtype == np.float32 and got.shape == (28, 28)
        errs.append(np.abs(got.astype(np.float64) - jstore.load_cam(fid))
                    .max())
        assert abs(tstore.thresholds[fid] - want_t) <= DUMP_THRESH_ATOL, fid
    assert max(errs) <= DUMP_CAM_ATOL, max(errs)


# -------------------------------------------------------------------- eval
def _small_unet(args, override_arch_for_classifier=False, device="cpu"):
    return torch_model(jax_variables(jax_model(args.freeze_cl), seed=2),
                       freeze_cl=args.freeze_cl).to(device)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """The trainer's validation and test passes (cli/train.main with 0
    epochs: the same initial weights) and cli/evaluate.py, each under
    compute_dtype bfloat16 and float32 (eval_compute_dtype float32), and
    cli/evaluate.py at eval_compute_dtype bfloat16; every CAM and logit
    that the eval steps return, and the convolutions' weight dtypes."""
    root = str(tmp_path_factory.mktemp("eval_dtype"))
    out = make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    make_stand_in_cam_store(out["metadata_root"], os.path.join(root, "cams"),
                            seed=1)
    flags = ["--task", "TCAM", "--arch", "UnetTCAM", "--data_root", root,
             "--metadata_root", out["metadata_root"], "--std_cams_folder",
             os.path.join(root, "cams"), "--crop_size", str(CROP),
             "--resize_size", "40", "--batch_size", "4", "--eval_batch_size",
             "8", "--cam_curve_interval", "0.05", "--freeze_cl", "true",
             "--sl_tc", "true", "--device", "cpu"]
    runs = {}
    make_step = evaluator.make_cam_eval_step
    log = []      # one list of (cams, logits) per run

    def recording(model, args):
        step = make_step(model, args)

        def run(*a, **k):
            cams, logits = step(*a, **k)
            log[-1].append((cams.clone(), logits.clone()))
            return cams, logits
        return run

    def record(name, main, argv):
        log.append([])
        with conv_weight_dtypes() as seen:
            res = main(argv)
        runs[name] = {"outs": log[-1], "convs": seen, "res": res}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train, "create_model_from_args", _small_unet)
        mp.setattr(cli_eval, "create_model_from_args", _small_unet)
        mp.setattr(evaluator, "make_cam_eval_step", recording)
        for dtype in ("bfloat16", "float32"):
            record(f"train_{dtype}", cli_train.main, flags + [
                "--compute_dtype", dtype, "--max_epochs", "0", "--outd",
                os.path.join(root, dtype)])
        exp_dir = runs["train_bfloat16"]["res"]["outd"]
        for name, extra in (
                ("evaluate_bfloat16", ["--compute_dtype", "bfloat16"]),
                ("evaluate_float32", ["--compute_dtype", "float32"]),
                ("evaluate_eval_bfloat16", ["--eval_compute_dtype",
                                            "bfloat16"])):
            record(name, cli_eval.main, flags + extra + ["--exp_dir",
                                                         exp_dir])
    return runs


def _scores(res: dict) -> dict:
    """An evaluator result without its timing (and curves)."""
    return {k: v for k, v in res.items() if isinstance(v, (int, float, list))}


def _same_outputs(a, b):
    assert len(a["outs"]) == len(b["outs"]) > 0
    for (ca, la), (cb, lb) in zip(a["outs"], b["outs"]):
        assert ca.dtype == cb.dtype == torch.float32
        assert la.dtype == lb.dtype == torch.float32
        assert torch.equal(ca, cb) and torch.equal(la, lb)


def test_trainer_eval_runs_fp32_under_bf16_compute(eval_runs):
    """The trainer's val and test passes at compute_dtype bfloat16 are
    bit-equal to the same passes at float32: eval_compute_dtype rules."""
    a, b = eval_runs["train_bfloat16"], eval_runs["train_float32"]
    assert a["convs"] == b["convs"] == {torch.float32}
    assert len(a["outs"]) == 3 * 3      # val + 2 test passes, 3 batches
    _same_outputs(a, b)
    assert a["res"]["args"].compute_dtype == "bfloat16"
    assert a["res"]["test"].keys() == b["res"]["test"].keys()
    for tag, res in a["res"]["test"].items():
        assert _scores(res) == _scores(b["res"]["test"][tag]), tag


def test_evaluate_runs_fp32_under_bf16_compute(eval_runs):
    a, b = eval_runs["evaluate_bfloat16"], eval_runs["evaluate_float32"]
    assert a["convs"] == b["convs"] == {torch.float32}
    _same_outputs(a, b)
    assert _scores(a["res"]) == _scores(b["res"])


def test_evaluate_at_bf16_reads_its_logits_right(eval_runs):
    """eval_compute_dtype bfloat16 runs the eval in bf16 and returns bf16
    logits, which the evaluator reads as numbers (not as the bits of
    fp32 ones): within the forward's bf16 tolerance of the fp32 eval."""
    a = eval_runs["evaluate_eval_bfloat16"]
    b = eval_runs["evaluate_float32"]
    assert a["convs"] == {torch.bfloat16}
    assert len(a["outs"]) == len(b["outs"])
    for (ca, la), (cb, lb) in zip(a["outs"], b["outs"]):
        assert la.dtype == torch.bfloat16 and ca.dtype == torch.float32
        assert_close(la.float().numpy(), lb.numpy(), FWD_RTOL, "logits")
    assert a["res"]["classification"] == b["res"]["classification"]
