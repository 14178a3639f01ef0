"""Port parity of stage 1 (task STD_CL): the STDClassifier (WSOL ResNet,
layers 1,1,1,1, WGAP head, 10 classes) at 32 px on weights transplanted
from flax, one STD_CL train step against the JAX step with its optax
optimizer, the fc-weight CAM, the STD_CL eval step and the classifier CAM
function; and the stage-1 config, loss and head dispatch.  float32 on the
CPU on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CROP, assert_close, images, jax_classifier,
                                 jax_variables, torch_classifier)
from tcam_wsol_video_tpu.cams import extractors as jex
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.optim import \
    param_group_labels as jparam_group_labels
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_cam_eval_step as jeval
from tcam_wsol_video_tpu.engine.steps import \
    make_classifier_cam_fn as jcam_fn
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.core.config import (experiment_tag,
                                                   parse_args,
                                                   stage1_cam_recipe,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.engine.optim import (build_optimizer,
                                                    param_group_labels)
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import (make_cam_eval_step,
                                                    make_classifier_cam_fn,
                                                    make_train_step)
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.models import factory, poolings
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict

torch.set_num_threads(1)

# conv/BN chains of ~20 layers in fp32 summed in another order, relative
# to the largest entry (see test_torch_models); CAMs are min-max
# normalized, so the same bound holds in [0, 1]
FWD_RTOL = 1e-4
BN_RTOL = 1e-4
# per-tensor parameter update relative to its largest entry, plus a few
# ulp of the parameter for p + update on each side (see test_torch_step)
DELTA_RTOL = 2e-3
DELTA_ULPS = 4
B = 3


def _recipe():
    # fp32 on both sides (the bf16 policy is held in test_torch_dtype.py)
    return stage1_cam_recipe(crop_size=CROP, batch_size=B, lr=0.01,
                             compute_dtype="float32")


def _jax_args(targs):
    cfg = get_config(C.YTOV1)
    cfg.update(dict(targs.__dict__))
    return HParams(cfg)


@pytest.fixture(scope="module")
def setup():
    jm = jax_classifier()
    return jm, jax_variables(jm, seed=5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_forward_inference_mode(setup):
    jm, variables = setup
    x = images(np.random.default_rng(3), 2)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    tm = torch_classifier(variables).eval()
    with torch.no_grad():
        got = tm(_t(x))
    assert got["cams_head"] is None and want["cams_head"] is None
    assert_close(got["cl_logits"].numpy(), want["cl_logits"], FWD_RTOL,
                 "cl_logits")
    assert len(got["features"]) == len(want["features"]) == 6
    for i, (g, w) in enumerate(zip(got["features"], want["features"])):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w, FWD_RTOL,
                     f"feature {i}")
    head, _ = tm.head_from_features(got["features"][-1])
    assert torch.equal(head, got["cl_logits"])


def test_forward_training_mode_and_bn_stats(setup):
    jm, variables = setup
    x = images(np.random.default_rng(4), 3)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    tm = torch_classifier(variables).train()
    with torch.no_grad():
        got = tm(_t(x))
    assert_close(got["cl_logits"].numpy(), want["cl_logits"], FWD_RTOL,
                 "cl_logits")
    new = flax_to_state_dict({"params": variables["params"],
                              "batch_stats": upd["batch_stats"]})
    sd = tm.state_dict()
    stats = [k for k in new if "running_" in k]
    assert stats and all(k.startswith("encoder.") for k in stats)
    for k in stats:
        assert_close(sd[k].numpy(), new[k], BN_RTOL, k)


def test_transplant_names_match_unet_components(setup):
    """Stage 2 loads `encoder` and `classification_head` from a stage-1
    snapshot: the classifier's tensors are exactly those components of
    UnetTCAM, under the same names."""
    _, variables = setup
    tm = torch_classifier(variables)
    unet = create_model_from_args(stage2_tcam_recipe(), device="cpu")
    cls = create_model_from_args(stage2_tcam_recipe(),
                                 override_arch_for_classifier=True,
                                 device="cpu")
    assert type(cls).__name__ == "STDClassifier"
    own = {k for k in unet.state_dict()
           if k.startswith(("encoder.", "classification_head."))}
    assert set(cls.state_dict()) == own
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "encoder", "classification_head"}
    fc = variables["params"]["classification_head"]["fc"]["kernel"]
    np.testing.assert_array_equal(
        tm.classification_head.fc.weight.detach().numpy(), fc.T)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": images(rng, B),
            "label": rng.integers(0, 10, B).astype(np.int32)}


@pytest.fixture(scope="module")
def stepped(setup):
    """One JAX STD_CL step and one port step from the same state and
    batch, then each side's eval step and classifier CAMs."""
    jm, variables = setup
    targs = _recipe()
    args = _jax_args(targs)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    batch = _batch(6)
    key = jax.random.PRNGKey(2)
    new_jstate, jmet = jstep(jm, ml, opt, args)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        ml.switches(0), key, jnp.float32(0.0))
    jcams, jlogits = jeval(jm, args)(
        new_jstate.params, new_jstate.batch_stats,
        jnp.asarray(batch["image"]), jnp.asarray(batch["label"]), key)
    jlo = jcam_fn(jm, args)(new_jstate.params, new_jstate.batch_stats,
                            jnp.asarray(batch["image"]),
                            jnp.asarray(batch["label"]))

    tm = torch_classifier(variables)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tmet = make_train_step(tml, targs)(tstate, tbatch, tml.switches(0),
                                       False)
    tcams, tlogits = make_cam_eval_step(tm, targs)(
        tbatch["image"], targets=tbatch["label"])
    tlo = make_classifier_cam_fn(tm, targs)(tbatch["image"],
                                            tbatch["label"])
    return dict(variables=variables, jstate=new_jstate, jmet=jmet, tm=tm,
                tmet=tmet, jcams=jcams, jlogits=jlogits, tcams=tcams,
                tlogits=tlogits, jlo=jlo, tlo=tlo)


N_STEPS = 4
# the models in float64 on both sides; both take the cross-entropy of
# float32 logits (~1e-7 relative a step), which the loss's divergence at
# this rate (2.7 -> 92 in 4 steps, on both sides) amplifies: the loss of
# each step, and the sum of N_STEPS updates relative to the largest one
# per tensor (measured: 3.5e-5 at most)
LOSS64_RTOL = 1e-6
DELTA64_RTOL = 1e-4


@pytest.fixture(scope="module")
def stepped_n64(setup):
    """N_STEPS consecutive STD_CL steps at the stage-1 rate (lr 0.01, 0.1
    on layer4 and the head) on both sides, from the same state, one new
    batch a step, so that the nesterov momentum trace and the weight
    decay carry across steps (a first step starts from an empty trace).
    The models, weights and images in float64 (JAX under enable_x64): in
    float32 the reference's own gradients carry the cancellation of
    flax's one-pass BatchNorm variance (up to ~8% of a layer4 conv
    gradient at batch 8 against a float64 run, where the port's are
    within 5e-6), and the divergence amplifies it past one step."""
    from tcam_wsol_video_tpu.models.classifier import \
        STDClassifier as JSTDClassifier
    from tcam_wsol_video_tpu.models.resnet import ResNetWSOL as JResNetWSOL
    _, variables = setup
    targs = _recipe()
    args = _jax_args(targs)
    with jax.enable_x64(True):
        f64 = jnp.float64
        jm = JSTDClassifier(encoder=JResNetWSOL(layers=(1, 1, 1, 1),
                                                dtype=f64),
                            pooling="WGAP", classes=10, dtype=f64)
        jvars = jax.tree_util.tree_map(lambda v: jnp.asarray(v, f64),
                                       variables)
        ml = jget_loss(args)
        opt = jbuild_opt(args, jvars["params"], lambda e: args.lr)
        jstate = JState.create(jvars, opt.init(jvars["params"]),
                               args.elb_init_t)
        jfn = jstep(jm, ml, opt, args)
        tm = torch_classifier(variables).double()
        tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                            targs.elb_init_t)
        tml = get_loss(targs)
        # the port's step computes in its config's dtype: float64 here, a
        # name the config itself refuses
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(factory.DTYPES, "float64", torch.float64)
            tfn = make_train_step(tml, targs.replace(compute_dtype="float64"))
        losses = []
        for i in range(N_STEPS):
            batch = _batch(20 + i)
            batch["image"] = batch["image"].astype(np.float64)
            jstate, jmet = jfn(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                               ml.switches(0), jax.random.PRNGKey(i),
                               jnp.float32(0.0))
            tmet = tfn(tstate, {k: _t(v) for k, v in batch.items()},
                       tml.switches(0), False)
            losses.append((float(tmet["loss"]), float(jmet["loss"])))
        new = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats}))
    return dict(old=flax_to_state_dict(variables), new=new, tm=tm,
                tstate=tstate, losses=losses)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_multi_step_losses_match_float64(stepped_n64, step):
    got, want = stepped_n64["losses"][step]
    assert abs(got - want) <= LOSS64_RTOL * abs(want), (step, got, want)


def test_multi_step_parameter_updates_match_optax(stepped_n64):
    """The summed update of N_STEPS steps, per tensor, and the BN
    statistics after them."""
    assert stepped_n64["tstate"].step == N_STEPS
    old, new = stepped_n64["old"], stepped_n64["new"]
    sd = stepped_n64["tm"].state_dict()
    for k, want in new.items():
        got = sd[k].numpy()
        if "running_" in k:
            assert_close(got, want, DELTA64_RTOL, k)
            continue
        d_got, d_want = got - old[k], want - old[k]
        assert np.abs(d_want).max() > 0, k
        assert_close(d_got, d_want, DELTA64_RTOL, k)


@pytest.mark.parametrize("term", ["loss", "cl_loss"])
def test_step_loss_matches(stepped, term):
    got = float(stepped["tmet"][term])
    want = float(stepped["jmet"][term])
    assert abs(got - want) <= FWD_RTOL * abs(want), (term, got, want)


def test_step_counts_match(stepped):
    for k in ("n_correct", "n"):
        assert int(stepped["tmet"][k]) == int(stepped["jmet"][k]), k


def test_step_parameter_updates_match_optax(stepped):
    old = flax_to_state_dict(stepped["variables"])
    new = flax_to_state_dict({"params": stepped["jstate"].params,
                              "batch_stats": stepped["jstate"].batch_stats})
    sd = stepped["tm"].state_dict()
    for k, want in new.items():
        got = sd[k].numpy()
        if "running_" in k:
            assert_close(got, want, BN_RTOL, k)
            continue
        d_got, d_want = got - old[k], want - old[k]
        assert np.abs(d_want).max() > 0, k
        tol = (DELTA_RTOL * np.abs(d_want).max()
               + DELTA_ULPS * np.finfo(np.float32).eps * np.abs(old[k]).max())
        assert np.abs(d_got - d_want).max() <= tol, k


def test_classifier_rate_groups_match(setup):
    """classification_head and encoder.layer4* train at lr x
    lr_classifier_ratio, as JAX's param_group_labels says."""
    _, variables = setup
    tm = torch_classifier(variables)
    labels = param_group_labels(tm, "resnet50")
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    want = {}
    for path, lab in jax.tree_util.tree_leaves_with_path(
            jparam_group_labels(variables["params"], "resnet50")):
        keys = [p.key for p in path]
        want[".".join(keys[:-1] + [leaf[keys[-1]]])] = lab
    assert labels == want
    heads = {k for k, v in labels.items() if v == "head"}
    assert heads == {k for k in labels if k.startswith(
        ("classification_head.", "encoder.layer4"))}
    opt = build_optimizer(_recipe(), tm, 0.01)
    assert [g["lr"] for g in opt.param_groups] == [0.01, 0.1]


def test_eval_step_cams_match(stepped):
    assert stepped["tcams"].shape == (B, CROP, CROP)
    assert_close(stepped["tcams"].numpy(), stepped["jcams"], FWD_RTOL,
                 "cams")
    assert_close(stepped["tlogits"].numpy(), stepped["jlogits"], FWD_RTOL,
                 "logits")
    assert float(stepped["tcams"].min()) >= 0.0
    assert float(stepped["tcams"].max()) <= 1.0


def test_classifier_cam_fn_matches(stepped):
    """At the last feature's resolution (4 x 4 at 32 px)."""
    assert stepped["tlo"].shape == (B, 4, 4)
    assert_close(stepped["tlo"].numpy(), stepped["jlo"], FWD_RTOL,
                 "classifier cams")


@pytest.mark.parametrize("support_background", [False, True],
                         ids=["plain", "support_background"])
def test_cam_fc_weights_matches(support_background):
    rng = np.random.default_rng(8)
    b, h, w, c, k = 4, 5, 6, 16, 10 + int(support_background)
    feats = rng.standard_normal((b, h, w, c)).astype(np.float32)
    fc = rng.standard_normal((c, k)).astype(np.float32)       # flax (C, K)
    labels = np.array([2, 0, 9, 2], np.int32)
    col = 2 + int(support_background)
    # a constant map (exact sums of 0.25, so both sides see one value
    # everywhere) normalizes to NaN -> 0; a NaN weight drops its channel
    fc[:, col] = 0.25
    fc[3, col] = np.nan
    feats[3] = 1.0
    want = jex.cam_fc_weights(jnp.asarray(feats), jnp.asarray(fc),
                              jnp.asarray(labels), support_background)
    got = ex.cam_fc_weights(_t(feats).permute(0, 3, 1, 2), _t(fc.T.copy()),
                            _t(labels), support_background)
    assert_close(got.numpy(), want, FWD_RTOL, "cam")
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got[3].numpy(), np.zeros((h, w)))
    # no ReLU: the map is min-max scaled, so it spans [0, 1] exactly
    for i in range(3):
        assert got[i].min() == 0.0 and got[i].max() == 1.0


def test_stage1_recipe_matches_the_yaml():
    import os
    import yaml
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "config_yaml", "ytov1_stage1_cam.yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    cfg = stage1_cam_recipe()
    for k, v in want.items():
        assert getattr(cfg, k) == v, k
    assert len(want) == 9


def test_both_stages_share_the_experiment_tag():
    s1, _ = parse_args(["--task", "STD_CL"])
    s2, _ = parse_args(["--task", "TCAM", "--arch", "UnetTCAM"])
    assert experiment_tag(s1) == experiment_tag(s2) == (
        "YouTube-Objects-v1.0-resnet50-CAM-WGAP-cp_best_localization-"
        "boxv2_True")


@pytest.mark.parametrize("flags,err", [
    (["--arch", "UnetTCAM"], ValueError),
    # every JAX method is ported: an unknown one is refused, and a method
    # with another head than the one it requires (JAX's hparams rule)
    (["--method", "NoSuchMethod"], ValueError),
    (["--spatial_pooling", "GAP"], ValueError),
    (["--spatial_pooling", "NoSuchHead"], ValueError)],
    ids=["arch", "method", "head", "unknown_head"])
def test_std_cl_checks_refuse(flags, err):
    with pytest.raises(err):
        parse_args(["--task", "STD_CL"] + flags)


@pytest.mark.parametrize("name,err", [
    ("GAP", None), ("MaxPool", None), ("LogSumExpPool", None),
    ("WildCatCLHead", None), ("nope", ValueError)])
def test_other_heads_raise(name, err):
    """Every head of the JAX package builds (tests/test_torch_heads.py
    holds them against JAX); an unknown name raises."""
    if err is None:
        assert poolings.build_pooling_head(name, 8, 3).builtin_cam
        return
    with pytest.raises(err):
        poolings.build_pooling_head(name, 8, 3)


def test_get_loss_dispatch():
    assert [l.__name__ for l in get_loss(stage1_cam_recipe()).losses] == [
        "cl_loss"]
    assert "con_ran_field_tcams" in [
        l.__name__ for l in get_loss(stage2_tcam_recipe()).losses]
