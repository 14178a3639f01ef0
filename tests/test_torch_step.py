"""Port parity: one stage-2 TCAM train step and the eval CAM step.

Both packages start from the same weights (flax init, transplanted), get
the same batch, and the port's seeder gets the JAX step's Gumbel noise
(derived from the step key as the JAX step splits it).  Compared: each
loss term, every parameter's update against optax, the BN statistics, and
the eval CAMs after the step.  float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CROP, assert_close, images, jax_model,
                                 jax_variables, torch_model)
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_cam_eval_step as jeval
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.core.config import (TCAMConfig, finalize,
                                                   stage2_tcam_production,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.engine.optim import (build_optimizer,
                                                    param_group_labels)
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import (make_cam_eval_step,
                                                    make_train_step)
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict
from test_torch_seeding import jax_gumbel

torch.set_num_threads(1)

# loss terms: fp32 forward of the same network (see test_torch_models)
LOSS_RTOL = 1e-4
# per-tensor parameter update relative to its largest entry: gradients
# through the decoder in fp32, and torch's per-group lr in place of
# optax's scale-before-trace (equal in exact arithmetic); plus the fp32
# rounding of p + update on each side (a few ulp of the parameter)
DELTA_RTOL = 2e-3
DELTA_ULPS = 4
STATE_RTOL = 1e-4
B = 2


def _recipe():
    # fp32 on both sides: the port's compute dtype here, JAX's through
    # _jax_args (the bf16 policy is held in test_torch_dtype.py)
    return stage2_tcam_recipe(crop_size=CROP, batch_size=B,
                              compute_dtype="float32")


def _production():
    """The production recipe (landmark CRF, 10/10 seeds) at the test's
    size; 256 landmarks on the 32 x 32 frame (the grid gives 256)."""
    return stage2_tcam_production(crop_size=CROP, batch_size=B,
                                  crf_n_landmarks=256,
                                  compute_dtype="float32")


def test_config_defaults_match_hparams():
    ref = get_config(C.YTOV1)
    for k, v in TCAMConfig().__dict__.items():
        assert ref[k] == v, (k, ref[k], v)
    # the train data plane's keys, with JAX's defaults and choices
    cfg = TCAMConfig()
    assert (cfg.h2d_transfer, cfg.decode_cache_mb,
            cfg.train_device_cache_mb) == ("float32", 0, 0)
    for k in ("h2d_transfer", "decode_cache_mb", "train_device_cache_mb"):
        assert ref[k] == getattr(cfg, k), k
    assert finalize(cfg.replace(h2d_transfer="uint8")).h2d_transfer == "uint8"
    for bad in (dict(h2d_transfer="uint16"),
                dict(sl_tc_roi_method="roi_nope")):
        with pytest.raises(ValueError):
            finalize(cfg.replace(**bad))
    for method in C.ROI_SELECT:
        assert finalize(cfg.replace(sl_tc_roi_method=method))


def _jax_args(targs=None):
    """JAX's config of the port's `targs`: the same keys, so the same
    compute dtypes."""
    cfg = get_config(C.YTOV1)
    cfg.update({k: v for k, v in (targs or _recipe()).__dict__.items()})
    return HParams(cfg)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cam = rng.random((B, CROP, CROP)).astype(np.float32) ** 2
    roi = np.stack([roi_one_cam_np(c)[0] for c in cam])
    return {
        "image": images(rng, B),
        "raw_img": (rng.random((B, CROP, CROP, 3)) * 255).astype(np.float32),
        "label": rng.integers(0, 10, B).astype(np.int32),
        "std_cam": cam,
        "roi": roi.astype(np.int32),
        "msk_bbox": np.ones((B, CROP, CROP), np.float32),
    }


def _step_both(targs, post_process: bool = False) -> dict:
    """One JAX step and one port step from the same state under the
    recipe `targs`, then each package's eval step (with the mean-field
    CRF refinement when post_process)."""
    args = _jax_args(targs)
    jm = jax_model(freeze_cl=True)
    variables = jax_variables(jm, seed=1)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    scfg = JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)
    batch = _batch(2)
    key = jax.random.PRNGKey(9)
    new_jstate, jmet = jstep(jm, ml, opt, args, scfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), key, jnp.float32(1.0))
    if post_process:
        args = _jax_args(targs.replace(crf_post_process=True))
    jcams, jlogits = jeval(jm, args)(
        new_jstate.params, new_jstate.batch_stats,
        jnp.asarray(batch["image"]), jnp.asarray(batch["label"]), key,
        raw_images=jnp.asarray(batch["raw_img"]) if post_process else None)

    tm = torch_model(variables, freeze_cl=True)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss_tcam(targs)
    k_seed, _ = jax.random.split(key)
    gumbel = torch.from_numpy(jax_gumbel(k_seed, B, CROP * CROP))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["label"] = tbatch["label"].long()
    tmet = make_train_step(tml, targs, seeder_cfg_from_args(targs))(
        tstate, tbatch, tml.switches(0), True, gumbel=gumbel)
    if post_process:
        targs = targs.replace(crf_post_process=True)
    tcams, tlogits = make_cam_eval_step(tm, targs)(
        tbatch["image"], tbatch["raw_img"] if post_process else None)
    return dict(variables=variables, jstate=new_jstate, jmet=jmet,
                jcams=jcams, jlogits=jlogits, tm=tm, tmet=tmet,
                tcams=tcams, tlogits=tlogits)


@pytest.fixture(scope="module")
def stepped():
    """One JAX step and one port step from the same state."""
    return _step_both(_recipe())


@pytest.fixture(scope="module")
def stepped_production():
    """The same under the production recipe (landmark CRF), with the
    eval step's mean-field CRF refinement on."""
    return _step_both(_production(), post_process=True)


TERMS = ["loss", "self_learning_tcams", "con_ran_field_tcams",
         "max_size_positive_tcams"]


def _check_term(stepped, term):
    got = float(stepped["tmet"][term])
    want = float(stepped["jmet"][term])
    assert abs(got - want) <= LOSS_RTOL * abs(want), (term, got, want)


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms_match(stepped, term):
    _check_term(stepped, term)


@pytest.mark.parametrize("term", TERMS)
def test_production_step_loss_terms_match(stepped_production, term):
    _check_term(stepped_production, term)


def test_parameter_updates_match_optax(stepped):
    _check_updates(stepped)


def test_production_step_parameter_updates_match_optax(stepped_production):
    _check_updates(stepped_production)


def test_production_eval_with_crf_post_process_matches(stepped_production):
    # five mean-field iterations on top of the eval CAMs (STATE_RTOL of
    # the CAM, then the filters' fp32 noise through the softmax)
    assert_close(stepped_production["tcams"].numpy(),
                 stepped_production["jcams"], 1e-3, "refined cams")


def _check_updates(stepped):
    old = flax_to_state_dict(stepped["variables"])
    new = flax_to_state_dict({"params": stepped["jstate"].params,
                              "batch_stats": stepped["jstate"].batch_stats})
    sd = stepped["tm"].state_dict()
    labels = param_group_labels(stepped["tm"], "resnet50")
    n_frozen = 0
    for k, want in new.items():
        got = sd[k].numpy()
        if "running_" in k:
            assert_close(got, want, STATE_RTOL, k)
            continue
        d_got, d_want = got - old[k], want - old[k]
        tol = (DELTA_RTOL * np.abs(d_want).max()
               + DELTA_ULPS * np.finfo(np.float32).eps * np.abs(old[k]).max())
        assert np.abs(d_got - d_want).max() <= tol, k
        if k.startswith(("encoder.", "classification_head.")):
            # frozen under freeze_cl, yet decayed by the optax chain
            if np.abs(old[k]).max() > 0:
                n_frozen += 1
                assert np.abs(want - old[k]).max() > 0, k
    assert n_frozen > 0
    assert {"head", "base"} == set(labels.values())


def test_eval_cams_match(stepped):
    assert_close(stepped["tcams"].numpy(), stepped["jcams"], STATE_RTOL,
                 "cams")
    assert_close(stepped["tlogits"].numpy(), stepped["jlogits"], STATE_RTOL,
                 "logits")


def test_production_recipe_matches_the_script():
    """Every flag of cmds/train_stage2_tcam_ytov1.sh that the port's
    config carries has the script's value in stage2_tcam_production
    (the paths, built from shell variables, are the caller's)."""
    import os
    import shlex
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "cmds",
                        "train_stage2_tcam_ytov1.sh")
    text = open(path).read()
    main = text[text.index("python main.py"):]
    main = main[:main.index("--exp_id")].replace("\\\n", " ")
    toks = shlex.split(main)[2:]
    flags = dict(zip(toks[0::2], toks[1::2]))
    cfg = stage2_tcam_production()
    n = 0
    for flag, raw in flags.items():
        key = flag.lstrip("-")
        if key not in cfg.__dict__ or "${" in raw:
            continue
        want = getattr(cfg, key)
        if isinstance(want, bool):
            assert want == (raw == "true"), key
        else:
            assert want == type(want)(raw), (key, want, raw)
        n += 1
    assert n >= 18, n
    assert cfg.crf_impl == "landmarks" and cfg.crf_n_landmarks == 1024
    assert (cfg.sl_tc_min, cfg.sl_tc_max, cfg.sl_tc_ksz) == (10, 10, 1)
