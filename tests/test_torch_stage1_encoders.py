"""Stage 1 and the U-Net on the other encoders, against the JAX package on
the CPU:
- one STD_CL train step (the port's against JAX's with its optax
  optimizer, from the same transplanted state and batch) for VGG16 with
  GAP, ResNet-101 with LogSumExpPool and InceptionV3 with WildCat (no
  head dropout; the SPG blocks' dropout live, with the same numpy masks
  on both sides), in float64 (JAX under enable_x64): in float32 the
  reference's one-pass BatchNorm variance carries cancellation that the
  deep encoders amplify (see test_torch_stage1 and test_torch_encoders);
- UnetTCAM's forward on VGG16 (the decoder's center block, three
  decoder blocks) and on InceptionV3 (the nearest-then-bilinear snap to
  odd skip sizes), with a GAP head and the background class;
- the dump's built-in route (make_classifier_cam_fn on a GAP head)
  against JAX's make_classifier_cam_fn;
- cli/train.py STD_CL with vgg16/GAP at crop 32 for one epoch, then the
  dump's built-in route and cli/evaluate.py from its snapshots.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CLASSES, SpgMasks, assert_close, images,
                                 jax_std_classifier, jax_variables,
                                 torch_std_classifier)
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import \
    make_classifier_cam_fn as jcam_fn
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu.models.factory import create_model as jcreate
from tcam_wsol_video_tpu_torch.cli import dump_cams, evaluate
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import stage1_cam_recipe
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.synthetic import make_synthetic_dataset
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import (make_classifier_cam_fn,
                                                    make_train_step)
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.models import factory
from tcam_wsol_video_tpu_torch.models.transplant import (flax_to_state_dict,
                                                         load_flax_variables)

torch.set_num_threads(1)

# float64 on both sides; both take the cross-entropy of float32 logits
# (~1e-7 relative), as test_torch_stage1's float64 steps: the loss, and
# each tensor's update relative to its largest entry
LOSS64_RTOL = 1e-6
DELTA64_RTOL = 1e-4
# fp32 forwards (and CAMs in [0, 1]) relative to the largest entry
FWD_RTOL = 1e-4
B = 2
PAIRS = [("vgg16", "GAP"), ("resnet101", "LogSumExpPool"),
         ("inceptionv3", "WildCatCLHead")]


def _jax_args(targs) -> HParams:
    cfg = get_config(JC.YTOV1)
    cfg.update(dict(targs.__dict__))
    return HParams(cfg)


def _recipe(encoder, pooling):
    method = {"GAP": "GAP", "LogSumExpPool": "LogSumExpPool",
              "WildCatCLHead": "WildCat"}[pooling]
    return stage1_cam_recipe(crop_size=32, batch_size=B, lr=0.01,
                             encoder_name=encoder, spatial_pooling=pooling,
                             method=method, compute_dtype="float32",
                             wc_kmax=0.3, lse_r=5.0)


@pytest.mark.parametrize("encoder,pooling", PAIRS,
                         ids=[e for e, _ in PAIRS])
def test_std_cl_step_matches_optax_float64(encoder, pooling, monkeypatch):
    targs = _recipe(encoder, pooling)
    args = _jax_args(targs)
    head_kw = dict(lse_r=5.0, wc_kmax=0.3)
    variables = jax_variables(jax_std_classifier(encoder, pooling,
                                                 **head_kw), seed=4)
    rng = np.random.default_rng(8)
    batch = {"image": images(rng, B).astype(np.float64),
             "label": rng.integers(0, CLASSES, B).astype(np.int32)}
    masks = SpgMasks(monkeypatch, seed=6)
    with jax.enable_x64(True):
        f64 = jnp.float64
        jm = jax_std_classifier(encoder, pooling, dtype=f64, **head_kw)
        jv = jax.tree_util.tree_map(lambda v: jnp.asarray(v, f64),
                                    variables)
        ml = jget_loss(args)
        opt = jbuild_opt(args, jv["params"], lambda e: args.lr)
        jstate = JState.create(jv, opt.init(jv["params"]), args.elb_init_t)
        jstate, jmet = jstep(jm, ml, opt, args)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            ml.switches(0), jax.random.PRNGKey(0), jnp.float32(0.0))
        # the update itself (transplant rounds to float32: relative to
        # the update, not to the parameter)
        delta = flax_to_state_dict(jax.tree_util.tree_map(
            lambda n, o: np.asarray(n - o),
            {"params": jstate.params, "batch_stats": jstate.batch_stats},
            {"params": jv["params"],
             "batch_stats": jv.get("batch_stats", {})}))
        jloss = float(jmet["loss"])
    tm = torch_std_classifier(variables, encoder, pooling,
                              **head_kw).double()
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    monkeypatch.setitem(factory.DTYPES, "float64", torch.float64)
    tmet = make_train_step(tml, targs.replace(compute_dtype="float64"))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        tml.switches(0), False)
    if encoder == "inceptionv3":
        assert masks._jax_i == masks._torch_i == 2
    assert abs(float(tmet["loss"]) - jloss) <= LOSS64_RTOL * abs(jloss)
    old = flax_to_state_dict(variables)
    sd = tm.state_dict()
    for k, d_want in delta.items():
        d_got = sd[k].numpy() - old[k]
        assert np.abs(d_want).max() > 0, k
        assert_close(d_got, d_want, DELTA64_RTOL, k)


@pytest.mark.parametrize("encoder", ["vgg16", "inceptionv3"])
def test_unet_tcam_forward_matches_jax(encoder):
    """UnetTCAM (GAP head with the background class, the JAX factory's
    decoder for the encoder) in inference mode, fp32."""
    jm = jcreate("TCAM", encoder, CLASSES, "GAP", support_background=True)
    variables = jax_variables(jm, seed=2)
    tm = factory.create_model(
        "TCAM", encoder, CLASSES, "GAP",
        head_kw={"support_background": True}, device="cpu").eval()
    load_flax_variables(tm, variables)
    assert (tm.decoder.center is not None) == (encoder == "vgg16")
    assert tm.decoder.blocks == (3 if encoder == "vgg16" else 5)
    x = images(np.random.default_rng(9), B)
    want = jm.apply(variables, x, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got["fcams"].numpy(), want["fcams"], FWD_RTOL, "fcams")
    assert_close(got["cl_logits"].numpy(), want["cl_logits"], FWD_RTOL,
                 "logits")
    assert got["cams_head"].shape[1] == CLASSES + 1
    assert_close(got["cams_head"].permute(0, 2, 3, 1).numpy(),
                 want["cams_head"], FWD_RTOL, "cams_head")


@pytest.mark.parametrize("bg", [False, True], ids=["fg", "bg"])
def test_dump_builtin_route_matches_jax(bg):
    targs = _recipe("vgg16", "GAP").replace(support_background=bg)
    variables = jax_variables(jax_std_classifier(
        "vgg16", "GAP", support_background=bg), seed=3)
    jm = jax_std_classifier("vgg16", "GAP", support_background=bg)
    tm = torch_std_classifier(variables, "vgg16", "GAP",
                              support_background=bg)
    x = images(np.random.default_rng(5), B)
    y = np.array([3, 0], np.int32)
    want = jcam_fn(jm, _jax_args(targs))(variables["params"], {},
                                         jnp.asarray(x), jnp.asarray(y))
    got = make_classifier_cam_fn(tm, targs)(torch.from_numpy(x),
                                            torch.from_numpy(y).long())
    assert got.dtype == torch.float32 and got.shape == (B, 4, 4)
    assert_close(got.numpy(), want, FWD_RTOL, "cams")


def _common(root):
    return ["--dataset", "YouTube-Objects-v1.0", "--data_root", root,
            "--metadata_root", os.path.join(root, "folds"),
            "--crop_size", "32", "--resize_size", "40",
            "--cam_curve_interval", "0.05", "--eval_batch_size", "8",
            "--log_every", "0", "--encoder_name", "vgg16",
            "--spatial_pooling", "GAP", "--method", "GAP", "--task",
            "STD_CL", "--device", "cpu"]


def test_cli_std_cl_vgg16_gap(tmp_path):
    """One epoch of cli/train.py, then the dump (built-in route) and
    cli/evaluate.py at the best-localization snapshot, against the
    trainer's own test pass."""
    root = str(tmp_path)
    make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    out = cli_train.main(_common(root) + [
        "--batch_size", "4", "--max_epochs", "1", "--lr", "0.01",
        "--checkpoint_save", "0", "--outd", os.path.join(root, "exps"),
        "--exp_id", "s1"])
    assert "vgg16-GAP-GAP" in out["outd"]
    test = out["test"][C.BEST_LOC]
    assert test["n_images"] > 0
    dump = dump_cams.main(_common(root) + [
        "--exp_dir", out["outd"], "--out", os.path.join(root, "store")])
    store = CamStore(os.path.join(root, "store"))
    cams = [store.load_cam(f) for f in list(store.thresholds)[:4]]
    assert dump["n_frames"] > 0 and all(
        c.shape == (28, 28) and 0.0 <= c.min() and c.max() <= 1.0
        for c in cams)
    res = evaluate.main(_common(root) + ["--exp_dir", out["outd"]])
    for s in (30, 50, 70):
        assert res[f"maxboxacc_{s}"] == test[f"maxboxacc_{s}"], s


def test_dump_refuses_wgap_methods_other_than_cam(tmp_path):
    args = stage1_cam_recipe(method=C.METHOD_GRADCAM)
    with pytest.raises(ValueError, match="GradCam"):
        dump_cams.dump_cams(args, str(tmp_path), str(tmp_path / "out"),
                            device="cpu")
