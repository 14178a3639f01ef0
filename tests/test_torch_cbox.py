"""Port parity of the C_BOX task on the CPU: box_stats (values and the
gradient to the box, boxes on pixel edges included), the Gaussian blur,
the composites, cbox_seeder (masks equal under the JAX seeder's own
noise, constant maps included), the four losses and get_loss_cbox's
gating, DenseBoxNet with and without freeze_encoder on weights
transplanted from flax, build_size_priors, one C_BOX train step (loss
terms, new parameters and BN statistics) and the eval step against the
JAX steps, and BoxEvaluator's bbox path.  Then the port's C_BOX trainer
epoch and evaluator, and STD_CL -> C_BOX -> evaluate through the CLIs
(the port's counterpart of tests/test_cbox_e2e.py), and the JAX quirks
the port keeps.  float32 on both sides, crop 32, ResNet layers 1,1,1,1.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CROP, LAYERS, assert_close, images,
                                 jax_classifier, jax_variables,
                                 torch_classifier)
from tcam_wsol_video_tpu.cams.seeding import CBoxSeederCfg as JCfg
from tcam_wsol_video_tpu.cams.seeding import cbox_seeder as jcbox_seeder
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.data.folds import SplitMetadata as JMeta
from tcam_wsol_video_tpu.data.folds import \
    build_size_priors as jbuild_size_priors
from tcam_wsol_video_tpu.engine import cbox_steps as jcbox_steps
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.losses import cbox as jcbox
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu.metrics.wsol import BoxEvaluator as JBoxEvaluator
from tcam_wsol_video_tpu.models.classifier import DenseBoxNet as JDenseBoxNet
from tcam_wsol_video_tpu.models.resnet import ResNetWSOL as JResNetWSOL
from tcam_wsol_video_tpu.ops import box_stats as jbs
from tcam_wsol_video_tpu_torch.cams.seeding import (CBoxSeederCfg,
                                                    cbox_seeder,
                                                    cbox_seeder_cfg_from_args)
from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.data.folds import (SplitMetadata,
                                                  build_size_priors)
from tcam_wsol_video_tpu_torch.engine import cbox_steps
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.losses import cbox as tcbox
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.metrics.wsol import BoxEvaluator
from tcam_wsol_video_tpu_torch.models.classifier import DenseBoxNet
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
from tcam_wsol_video_tpu_torch.models.transplant import (flax_to_state_dict,
                                                         load_flax_variables)
from tcam_wsol_video_tpu_torch.ops import box_stats as tbs

torch.set_num_threads(1)

# elementwise fp32 on both sides: masks, areas and composites within a
# few ulp of the largest entry; the blur's 2 x ksize-term sums and the
# box gradient's sums over H W pixels in another order
ELEM_RTOL = 1e-6
SUM_RTOL = 1e-5
# conv/BN chains of ~20 layers in fp32 summed in another order (see
# test_torch_models.py); the loss terms of a step go through the frozen
# classifier's three forwards on top
FWD_RTOL = 1e-4
LOSS_RTOL = 1e-4
BN_RTOL = 1e-4
# per-tensor parameter update relative to its largest entry, plus a few
# ulp of the parameter for p + update on each side (test_torch_stage1.py)
DELTA_RTOL = 2e-3
DELTA_ULPS = 4
# the encoder's update in a C_BOX step, against JAX's in fp32: the box
# losses send nearly the same gradient to every image's box, and flax's
# one-pass BatchNorm variance in fp32 loses it to cancellation in JAX's
# backward (its fp32 encoder gradient lies up to ~30% from its own
# float64 one, where the port's is within 1e-5:
# test_encoder_gradient_matches_jax_float64); measured here: 7.6% at most
ENC_DELTA_RTOL = 1e-1
B = 4
H = W = CROP
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX_YAML = os.path.join(REPO, "config_yaml", "ytov1_cbox.yaml")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------- box_stats
def _boxes() -> np.ndarray:
    rng = np.random.default_rng(3)
    box = (rng.random((6, 4)) * 36 - 2).astype(np.float32)
    box[0] = [4.0, 6.0, 12.0, 14.0]      # integer edges: pixels on them
    box[1] = [0.0, 0.0, 23.0, 19.0]      # the image's own border
    box[2] = [9.0, 3.0, 2.0, 12.0]       # x2 < x1: invalid
    box[3] = [5.5, 2.25, 17.75, 15.5]
    return box


@pytest.mark.parametrize("eval_mode", [False, True], ids=["train", "eval"])
def test_box_stats_values_and_gradient_match_jax(eval_mode):
    """Every output of box_stats, and the gradient to the box of a
    weighted sum of the masks and the area (finite where a pixel lies on
    an edge, delta == 0)."""
    box = _boxes()
    h, w = 24, 20
    rng = np.random.default_rng(4)
    r_fg, r_bg = (rng.random((6, h, w)).astype(np.float32) for _ in "ab")
    r_a = rng.random(6).astype(np.float32)

    def jloss(b):
        out = jbs.box_stats(b, h, w, 1.5, eval_mode)
        return (jnp.sum(out[4] * r_fg) + jnp.sum(out[5] * r_bg)
                + jnp.sum(out[3] * r_a)), out
    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(box))

    tb = _t(box).requires_grad_(True)
    tout = tbs.box_stats(tb, h, w, 1.5, eval_mode)
    ((tout[4] * _t(r_fg)).sum() + (tout[5] * _t(r_bg)).sum()
     + (tout[3] * _t(r_a)).sum()).backward()
    for name, g, j in zip(("x", "y", "valid", "area", "m_fg", "m_bg"),
                          tout, jout):
        assert_close(g.detach().numpy(), j, ELEM_RTOL, name)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert np.isfinite(tb.grad.numpy()).all()
    assert np.abs(np.asarray(jgrad)).max() > 0
    assert_close(tb.grad.numpy(), jgrad, SUM_RTOL, "d box")


@pytest.mark.parametrize("ksize,sigma", [(9, 4.0), (65, 60.0)])
def test_gaussian_blur_matches_jax(ksize, sigma):
    """Zero-padded separable blur; 65 / 60 is the recipe's (wider than
    the 32 px image)."""
    x = images(np.random.default_rng(5), 2)
    want = jbs.gaussian_blur(jnp.asarray(x), ksize, sigma)
    got = tbs.gaussian_blur(_t(x), ksize, sigma)
    assert_close(got.numpy(), want, SUM_RTOL, "blur")


def test_composites_match_jax():
    rng = np.random.default_rng(6)
    x, blur = images(rng, 3), images(rng, 3)
    m_fg, m_bg = (rng.random((3, H, W)).astype(np.float32) for _ in "ab")
    for name in ("compose_fg_image", "compose_bg_image"):
        want = getattr(jbs, name)(*(jnp.asarray(a)
                                    for a in (x, blur, m_fg, m_bg)))
        got = getattr(tbs, name)(*(_t(a) for a in (x, blur, m_fg, m_bg)))
        assert_close(got.numpy(), want, ELEM_RTOL, name)


# ------------------------------------------------------------ cbox_seeder
def jax_cbox_noise(key, b: int, p: int, cfg) -> tuple:
    """(gumbel (B, 2, P), z (B,)): the fg/bg Gumbel draws and the bg
    fractions exactly as JAX's cbox_seeder makes them from `key`."""
    gumbel, z = [], []
    for k in jax.random.split(key, b):
        kf, kb, kz = jax.random.split(k, 3)
        gumbel.append([np.asarray(jax.random.gumbel(kf, (p,), jnp.float32)),
                       np.asarray(jax.random.gumbel(kb, (p,), jnp.float32))])
        z.append(np.asarray(jax.random.uniform(
            kz, (), minval=cfg.bg_low_z, maxval=cfg.bg_up_z)))
    return np.asarray(gumbel, np.float32), np.asarray(z, np.float32)


def _seed_cams(seed: int, b: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    cams = np.stack([np.exp(-((yy - rng.uniform(6, h - 6)) ** 2
                              + (xx - rng.uniform(6, w - 6)) ** 2)
                            / rng.uniform(20, 60)) for _ in range(b)])
    cams = (0.9 * cams + 0.1 * rng.random((b, h, w))).astype(np.float32)
    cams[-1] = 0.5          # constant: the median fallback
    cams[-2] = 0.0          # a CAM store's zero map (no store)
    return cams


SEEDER_CASES = {
    "recipe": dict(n=10, fg_erode_k=11, fg_erode_iter=1, ksz=3),
    "no_erode": dict(n=4, fg_erode_iter=0, ksz=1, bg_low_z=0.2,
                     bg_up_z=0.5),
    "bisect_topk": dict(n=40, fg_erode_k=3, fg_erode_iter=1, ksz=2),
    "even_ksz_fixed_z": dict(n=3, fg_erode_k=5, ksz=2, bg_low_z=0.3,
                             bg_up_z=0.3),
}


@pytest.mark.parametrize("case", sorted(SEEDER_CASES))
def test_cbox_seeder_masks_equal_with_injected_noise(case):
    kw = SEEDER_CASES[case]
    b, h, w = 5, 28, 32
    cams = _seed_cams(7, b, h, w)
    key = jax.random.PRNGKey(19)
    want = np.asarray(jax.jit(lambda k, c: jcbox_seeder(k, c, JCfg(**kw)))(
        key, jnp.asarray(cams)))
    gumbel, z = jax_cbox_noise(key, b, h * w, JCfg(**kw))
    got = cbox_seeder(_t(cams), CBoxSeederCfg(**kw), gumbel=_t(gumbel),
                      z=_t(z))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:3] == 1).any() and (want[:3] == 0).any()
    # a constant map seeds no foreground (its threshold is its own value)
    assert not (want[3:] == 1).any()


def test_cbox_seeder_draws_from_generator():
    cams = _t(_seed_cams(8, 3, 24, 24))
    cfg = CBoxSeederCfg(n=3, fg_erode_iter=0, ksz=1)

    def run(seed):
        return cbox_seeder(cams, cfg, generator=torch.Generator().manual_seed(
            seed))
    a, b = run(1), run(1)
    assert torch.equal(a, b) and not torch.equal(a, run(2))
    assert ((a == 1).sum((1, 2))[:1] == 3).all()


# ----------------------------------------------------------------- losses
LOSS_CASES = {
    "area_box": dict(cb_area_box=True, cb_area_box_l=0.7),
    "cl_scoring": dict(cb_cl_score=True, cb_cl_score_l=1.3),
    "seed_cbox": dict(cb_seed=True, cb_seed_l=0.9),
    "box_bounds": dict(cb_pp_box=True, cb_pp_box_l=1.1),
    "all_windows": dict(cb_area_box=True, cb_cl_score=True, cb_seed=True,
                        cb_pp_box=True, cb_area_box_start_epoch=1,
                        cb_cl_score_end_epoch=0, cb_seed_start_epoch=2,
                        cb_pp_box_end_epoch=3),
    "none": dict(),
}


def _loss_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = 10
    box = np.concatenate([rng.uniform(0, 12, (B, 2)),
                          rng.uniform(14, 31, (B, 2))], 1).astype(np.float32)
    box[1, 2] = -1.0                     # one invalid box
    seeds = rng.choice([0, 1, C.SEG_IGNORE_IDX], (B, H, W),
                       p=[0.05, 0.05, 0.9]).astype(np.int32)
    return {"box": box,
            "logits": rng.standard_normal((3, B, k)).astype(np.float32),
            "glabel": rng.integers(0, k, B).astype(np.int32),
            "seeds": seeds,
            "pre": rng.uniform(0, 31, (2, B, 2)).astype(np.float32)}


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("epoch", [0, 2])
def test_cbox_losses_and_gating_match_jax(case, epoch):
    """get_loss_cbox of each flag set on both sides: the losses present,
    their epoch windows, each term and the total, and the gradients to
    the box and the three logits; no flag raises on both sides."""
    targs = TCAMConfig(task=C.C_BOX, arch=C.DENSEBOXNET, **LOSS_CASES[case])
    jargs = HParams({**get_config(JC.YTOV1), **targs.__dict__})
    if case == "none":
        with pytest.raises(AssertionError):
            jget_loss(jargs)
        with pytest.raises(ValueError):
            get_loss(targs)
        return
    jml, tml = jget_loss(jargs), get_loss(targs)
    assert ([l.__name__ for l in tml.losses]
            == [l.__name__ for l in jml.losses])
    assert tml.switches(epoch) == np.asarray(jml.switches(epoch)).tolist()
    x = _loss_inputs(11)

    def jfn(box, logits):
        bx, by, valid, area, m_fg, m_bg = jbs.box_stats(box, H, W)
        inputs = jcbox.CBoxInputs(
            glabel=jnp.asarray(x["glabel"]), seeds=jnp.asarray(x["seeds"]),
            x_hat=bx, y_hat=by, valid=valid[:, None], area=area[:, None],
            m_fg=m_fg, m_bg=m_bg, logits_fg=logits[0], logits_bg=logits[1],
            logits_clean=logits[2], pre_x_hat=jnp.asarray(x["pre"][0]),
            pre_y_hat=jnp.asarray(x["pre"][1]))
        return jml.compute(inputs, 1.5, jml.switches(epoch))
    (jtot, jhold), jgrads = jax.value_and_grad(jfn, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x["box"]), jnp.asarray(x["logits"]))

    box = _t(x["box"]).requires_grad_(True)
    logits = _t(x["logits"]).requires_grad_(True)
    bx, by, valid, area, m_fg, m_bg = tbs.box_stats(box, H, W)
    inputs = tcbox.CBoxInputs(
        glabel=_t(x["glabel"]), seeds=_t(x["seeds"]), x_hat=bx, y_hat=by,
        valid=valid[:, None], area=area[:, None], m_fg=m_fg, m_bg=m_bg,
        logits_fg=logits[0], logits_bg=logits[1], logits_clean=logits[2],
        pre_x_hat=_t(x["pre"][0]), pre_y_hat=_t(x["pre"][1]))
    ttot, thold = tml.compute(inputs, 1.5, tml.switches(epoch))
    if not any(tml.switches(epoch)):
        assert float(ttot) == float(jtot) == 0.0
        return
    ttot.backward()
    assert sorted(thold) == sorted(jhold)
    for k in thold:
        assert_close(thold[k].detach().numpy(), jhold[k], LOSS_RTOL, k)
    assert_close(ttot.detach().numpy(), jtot, LOSS_RTOL, "total")
    for name, got, want in (("d box", box.grad, jgrads[0]),
                            ("d logits", logits.grad, jgrads[1])):
        got = np.zeros_like(want) if got is None else got.numpy()
        if np.abs(np.asarray(want)).max() == 0:
            assert np.abs(got).max() == 0.0, name
        else:
            assert_close(got, want, SUM_RTOL, name)


# ------------------------------------------------------------ DenseBoxNet
@pytest.fixture(scope="module")
def boxnet():
    return boxnet_variables()


def boxnet_variables() -> dict:
    """The DenseBoxNet variables of the step tests (also read by
    tests/test_torch_mesh_step.py)."""
    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS))
    variables = jax_variables(jm, seed=8)
    # the box head's bias set so that the training forward's boxes on the
    # step's batch lie at (0, 4, 27, 26) (x1, y1, x2, y2) give or take
    # how they differ between images, x1 at 0 for the median image: a
    # trained box is valid for some images (x1 >= 0) and not for others
    out, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(
        variables, _step_batch(14)["image"])
    box = np.asarray(out["box"])
    shift = np.asarray([0.0, 4.0, 27.0, 26.0]) - np.concatenate(
        [np.median(box[:, :1], 0), box[:, 1:].mean(0)])
    head = variables["params"]["box_head"]
    variables["params"]["box_head"] = {
        "kernel": head["kernel"],
        "bias": (head["bias"] + shift).astype(np.float32)}
    return variables


def _torch_boxnet(variables, freeze_encoder=False) -> DenseBoxNet:
    model = DenseBoxNet(ResNetWSOL(layers=LAYERS), freeze_encoder)
    load_flax_variables(model, variables)
    return model


@pytest.mark.parametrize("freeze", [False, True], ids=["plain", "frozen"])
def test_dense_box_net_matches_jax(boxnet, freeze):
    """Forward in eval and training mode, the BN statistics after the
    training forward (a frozen encoder leaves them), and the gradients of
    a weighted sum of the boxes (a frozen encoder takes none)."""
    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS),
                      freeze_encoder=freeze)
    x = images(np.random.default_rng(9), 3)
    r = np.random.default_rng(10).standard_normal((3, 4)).astype(np.float32)
    want_eval = jax.jit(lambda v: jm.apply(v, x, train=False)["box"])(
        boxnet)

    def jfn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": boxnet["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out["box"] * r), (out["box"], upd["batch_stats"])
    (_, (want_train, jstats)), jgrad = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(boxnet["params"])

    tm = _torch_boxnet(boxnet, freeze)
    with torch.no_grad():
        got_eval = tm.eval()(_t(x))["box"]
    assert_close(got_eval.numpy(), want_eval, FWD_RTOL, "eval box")
    out = tm.train()(_t(x))
    assert tm.encoder.training is not freeze
    assert_close(out["box"].detach().numpy(), want_train, FWD_RTOL,
                 "train box")
    (out["box"] * _t(r)).sum().backward()
    new = flax_to_state_dict({"params": boxnet["params"],
                              "batch_stats": jstats})
    want_grads = flax_to_state_dict({"params": jgrad})
    sd = tm.state_dict()
    for k, v in new.items():
        if "running_" in k:
            assert_close(sd[k].numpy(), v, BN_RTOL, k)
    for name, p in tm.named_parameters():
        want = want_grads[name]
        if freeze and name.startswith("encoder."):
            assert p.grad is None and np.abs(want).max() == 0, name
        else:
            assert_close(p.grad.numpy(), want, FWD_RTOL, name)


def test_transplant_carries_the_box_head(boxnet):
    sd = _torch_boxnet(boxnet).state_dict()
    np.testing.assert_array_equal(sd["box_head.weight"].numpy(),
                                  boxnet["params"]["box_head"]["kernel"].T)
    np.testing.assert_array_equal(sd["box_head.bias"].numpy(),
                                  boxnet["params"]["box_head"]["bias"])


# ------------------------------------------------------ build_size_priors
def test_build_size_priors_bit_equal():
    rng = np.random.default_rng(12)
    ids = [f"v/{i}.jpg" for i in range(40)]
    labels = {i: int(rng.integers(0, 5)) for i in ids}   # 5 of 6 classes
    sizes = {i: (int(rng.integers(100, 400)), int(rng.integers(80, 300)))
             for i in ids}
    boxes = {}
    for i in ids[:-3]:                   # three frames without boxes
        w, h = sizes[i]
        boxes[i] = []
        for _ in range(int(rng.integers(1, 3))):
            x0, y0 = rng.integers(0, w - 10), rng.integers(0, h - 10)
            boxes[i].append((float(x0), float(y0),
                             float(rng.integers(x0 + 5, w)),
                             float(rng.integers(y0 + 5, h))))
    kw = dict(image_ids=ids, labels=labels, sizes=sizes, boxes=boxes)
    want = jbuild_size_priors(JMeta(split="val", **kw), 224, 6)
    got = build_size_priors(SplitMetadata(split="val", **kw), 224, 6)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], k)
    assert got["min_s"][5] == 0.0 and got["max_s"][5] == 1.0


# ------------------------------------------------------ train / eval step
STEP_FLAGS = dict(cb_area_box=True, cb_cl_score=True, cb_seed=True,
                  cb_pp_box=True, cb_seed_n=4, cb_seed_erode_k=3,
                  cb_seed_erode_iter=1, cb_seed_ksz=3,
                  cb_cl_score_blur_ksize=9, cb_cl_score_blur_sigma=4.0,
                  cb_init_box_var=0.1)
# the per-class minimum area share: classes 5-9 larger than any box here,
# so that their pre-forward boxes are replaced by drawn ones
PRIORS = np.asarray([0.05] * 5 + [0.9] * 5, np.float32)


def _step_args(**kw):
    targs = TCAMConfig(task=C.C_BOX, arch=C.DENSEBOXNET, crop_size=CROP,
                       batch_size=B, compute_dtype="float32",
                       eval_compute_dtype="float32",
                       **{"lr": 0.01, **STEP_FLAGS, **kw})
    return targs, HParams({**get_config(JC.YTOV1), **targs.__dict__})


def _step_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cams = _seed_cams(seed, B, CROP, CROP)
    return {"image": images(rng, B),
            "raw_img": (rng.random((B, CROP, CROP, 3)) * 255
                        ).astype(np.float32),
            "label": np.asarray([1, 6, 3, 8], np.int32),
            "std_cam": cams}


@pytest.fixture(scope="module")
def classifier_vars():
    return jax_variables(jax_classifier(), seed=13)


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "frozen"])
def stepped(request, boxnet, classifier_vars):
    """One JAX C_BOX step and one port step from the same state, batch,
    fallback-box normals and seeder noise (JAX's own key splits); with
    and without freeze_encoder."""
    freeze = request.param
    targs, jargs = _step_args(freeze_encoder=freeze)
    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS),
                      freeze_encoder=freeze)
    jcls = jax_classifier()
    jml = jget_loss(jargs)
    opt = jbuild_opt(jargs, boxnet["params"], lambda e: jargs.lr)
    jstate = JState.create(boxnet, opt.init(boxnet["params"]),
                           jargs.elb_init_t)
    scfg = JCfg(n=targs.cb_seed_n, fg_erode_k=targs.cb_seed_erode_k,
                fg_erode_iter=targs.cb_seed_erode_iter, ksz=targs.cb_seed_ksz)
    batch = _step_batch(14)
    key = jax.random.PRNGKey(15)
    new_jstate, jmet = jcbox_steps.make_cbox_train_step(
        jm, jcls, jml, opt, jargs, scfg, size_priors_min_s=PRIORS)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jml.switches(0), key, classifier_vars["params"],
        classifier_vars["batch_stats"])

    k_seed, k_rand = jax.random.split(key)
    gumbel, z = jax_cbox_noise(k_seed, B, CROP * CROP, scfg)
    noise = {"normal": _t(np.asarray(jax.random.normal(k_rand, (B,)))),
             "gumbel": _t(gumbel), "z": _t(z)}
    tm = _torch_boxnet(boxnet, freeze)
    tcls = torch_classifier(classifier_vars).requires_grad_(False)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss(targs)
    tmet = cbox_steps.make_cbox_train_step(
        tml, targs, cbox_seeder_cfg_from_args(targs), tcls,
        PRIORS)(tstate, {k: _t(v) for k, v in batch.items()},
                tml.switches(0), noise=noise)
    return dict(jstate=new_jstate, jmet=jmet, tm=tm, tmet=tmet, tcls=tcls,
                batch=batch, freeze=freeze)


def test_train_step_loss_terms_match_jax(stepped):
    jmet, tmet = stepped["jmet"], stepped["tmet"]
    terms = ("area_box", "cl_scoring", "seed_cbox", "box_bounds")
    for k in terms + ("loss",):
        assert_close(tmet[k].numpy(), jmet[k], LOSS_RTOL, k)
    for k in ("n_correct", "n", "valid_boxes"):
        assert int(tmet[k]) == int(jmet[k]), k
    if not stepped["freeze"]:           # a frozen encoder's boxes differ
        assert 0 < int(tmet["valid_boxes"]) < B
    # the frozen classifier is not trained
    assert all(p.grad is None for p in stepped["tcls"].parameters())


def test_train_step_parameter_updates_match_jax(stepped, boxnet):
    old = flax_to_state_dict(boxnet)
    new = flax_to_state_dict({"params": stepped["jstate"].params,
                              "batch_stats": stepped["jstate"].batch_stats})
    sd = stepped["tm"].state_dict()
    for k, want in new.items():
        got = sd[k].numpy()
        if "running_" in k:
            assert_close(got, want, BN_RTOL, k)
            continue
        d_got, d_want = got - old[k], want - old[k]
        if np.abs(d_want).max() == 0:      # zero BN biases under freezing
            assert stepped["freeze"] and np.abs(d_got).max() == 0, k
            continue
        rtol = (ENC_DELTA_RTOL if k.startswith("encoder.")
                and not stepped["freeze"] else DELTA_RTOL)
        tol = (rtol * np.abs(d_want).max()
               + DELTA_ULPS * np.finfo(np.float32).eps * np.abs(old[k]).max())
        assert np.abs(d_got - d_want).max() <= tol, k
    if stepped["freeze"]:       # BN statistics of a frozen encoder stay
        for k, v in old.items():
            if "running_" in k:
                np.testing.assert_array_equal(sd[k].numpy(), v, k)


def test_encoder_gradient_matches_jax_float64(boxnet):
    """DenseBoxNet's gradients under an upstream gradient nearly equal for
    every image (as the box losses give) on the step's batch: the port in
    fp32 against JAX in float64, and JAX's own fp32 gap beside it (what
    ENC_DELTA_RTOL allows for in the step's encoder update)."""
    x = _step_batch(14)["image"]
    rng = np.random.default_rng(21)
    g = (np.tile(rng.standard_normal((1, 4)), (B, 1))
         + 0.01 * rng.standard_normal((B, 4))).astype(np.float32)

    def jax_grads(dtype):
        with jax.enable_x64(dtype == jnp.float64):
            jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS,
                                                  dtype=dtype), dtype=dtype)
            v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                       boxnet)

            def f(params):
                out, _ = jm.apply({"params": params,
                                   "batch_stats": v["batch_stats"]},
                                  jnp.asarray(x, dtype), train=True,
                                  mutable=["batch_stats"])
                return jnp.sum(out["box"] * jnp.asarray(g, dtype))
            grads = jax.jit(jax.grad(f))(v["params"])
            return flax_to_state_dict({"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), grads)})
    j64, j32 = jax_grads(jnp.float64), jax_grads(jnp.float32)
    tm = _torch_boxnet(boxnet).train()
    (tm(_t(x))["box"] * _t(g)).sum().backward()
    jax_gap = 0.0
    for name, p in tm.named_parameters():
        scale = np.abs(j64[name]).max()
        assert_close(p.grad.numpy(), j64[name], FWD_RTOL, name)
        jax_gap = max(jax_gap, np.abs(j32[name] - j64[name]).max() / scale)
    assert jax_gap > ENC_DELTA_RTOL, jax_gap


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_eval_step_matches_jax(boxnet, classifier_vars, uint8):
    """Boxes (y0, x0, y1, x1 of the clamped box), validity and the
    classifier's logits of the fg composite; uint8 images normalized
    first."""
    targs, jargs = _step_args()
    rng = np.random.default_rng(16)
    x = ((rng.random((B, CROP, CROP, 3)) * 255).astype(np.uint8) if uint8
         else images(rng, B))
    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS))
    jb, jv, jl = jcbox_steps.make_cbox_eval_step(jm, jax_classifier(),
                                                 jargs)(
        boxnet["params"], boxnet["batch_stats"], classifier_vars["params"],
        classifier_vars["batch_stats"], jnp.asarray(x))
    tb, tv, tl = cbox_steps.make_cbox_eval_step(
        _torch_boxnet(boxnet), torch_classifier(classifier_vars),
        targs)(_t(x))
    assert_close(tb.numpy(), jb, FWD_RTOL, "boxes")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) > 0
    assert_close(tl.numpy(), jl, FWD_RTOL, "logits")


def test_init_boxes_match_jax():
    """The fallback boxes from the same normal draws: a std, clamped to
    [minimum, 0.99]."""
    key = jax.random.PRNGKey(17)
    minsz = np.asarray([0.5, 0.05, 0.05, 1.0], np.float32)
    jx, jy = jcbox_steps._init_boxes(key, 4, 32, 24, jnp.asarray(minsz),
                                     0.3, 0.4)
    normal = np.asarray(jax.random.normal(key, (4,)))
    tx, ty = cbox_steps.init_boxes(_t(normal), 32, 24, _t(minsz), 0.3, 0.4)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# ------------------------------------------------------------ BoxEvaluator
def test_box_evaluator_bbox_path_matches_jax():
    """An invalid box is a miss at every tau; a valid one is scored by
    its best IoU against the GT boxes at every tau."""
    rng = np.random.default_rng(18)
    taus = np.arange(0.0, 1.0, 0.05)
    jev, tev = JBoxEvaluator(taus), BoxEvaluator(taus)
    for i in range(30):
        gt = np.sort(rng.integers(0, 32, (int(rng.integers(1, 3)), 2, 2)),
                     axis=1).reshape(-1, 4)[:, [0, 2, 1, 3]].astype(
                         np.float32)
        x0, y0 = rng.uniform(0, 20, 2)
        box = [x0, y0, x0 + rng.uniform(1, 12), y0 + rng.uniform(1, 12)]
        status = int(i % 5 != 0)
        preds = rng.permutation(10)
        target = int(rng.integers(0, 10))
        jev.accumulate(None, gt, target, preds, bbox=box,
                       bbox_status=status)
        tev.accumulate_bbox(box, status, gt, target, preds)
    assert tev.compute() == jev.compute()
    assert tev.top1 == jev.top1 and tev.top5 == jev.top5
    assert tev.best_tau_list == jev.best_tau_list
    with pytest.raises(ValueError):
        tev.accumulate_bbox([0, 0, 1, 1], 2, gt, 0, preds)


# --------------------------------------------------------------- the quirks
class _Spy:
    """Wraps a MasterLoss and keeps the inputs of each compute."""

    def __init__(self, ml):
        self.ml, self.seen = ml, []
        self.losses = ml.losses

    def switches(self, epoch):
        return self.ml.switches(epoch)

    def compute(self, inputs, t, switches=None):
        self.seen.append(inputs)
        return self.ml.compute(inputs, t, switches)


def test_cb_area_normed_is_never_set(boxnet, classifier_vars):
    """JAX's step never sets CBoxInputs.area_normed from cb_area_normed
    (its AreaBox then bounds the area by H W); the port keeps that."""
    targs, jargs = _step_args(cb_area_normed=True)
    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=LAYERS))
    jml = _Spy(jget_loss(jargs))
    opt = jbuild_opt(jargs, boxnet["params"], lambda e: jargs.lr)
    batch = _step_batch(20)
    jcbox_steps.make_cbox_train_step(
        jm, jax_classifier(), jml, opt, jargs, JCfg(n=2))(
        JState.create(boxnet, opt.init(boxnet["params"])),
        {k: jnp.asarray(v) for k, v in batch.items()}, jml.switches(0),
        jax.random.PRNGKey(0), classifier_vars["params"],
        classifier_vars["batch_stats"])
    tm = _torch_boxnet(boxnet)
    tml = _Spy(get_loss(targs))
    cbox_steps.make_cbox_train_step(
        tml, targs, CBoxSeederCfg(n=2), torch_classifier(
            classifier_vars).requires_grad_(False))(
        TrainState(tm, build_optimizer(targs, tm, targs.lr)),
        {k: _t(v) for k, v in batch.items()}, tml.switches(0),
        generator=torch.Generator().manual_seed(0))
    assert targs.cb_area_normed and jargs.cb_area_normed
    assert jml.seen[0].area_normed is False
    assert tml.seen[0].area_normed is False


def test_classifier_loads_the_seeder_snapshot(tmp_path):
    """C_BOX's frozen classifier comes from tcam_pretrained_seeder_ch_pt
    (best_localization by default), not from cb_pretrained_cl_ch_pt
    (best_classification in the recipe), as the JAX CLIs load it."""
    args = parse_args(["--config", CBOX_YAML,
                       "--folder_pre_trained_cl", str(tmp_path)])[0]
    assert args.cb_pretrained_cl_ch_pt == C.BEST_CL
    assert args.tcam_pretrained_seeder_ch_pt == C.BEST_LOC
    kc = cli_train.KeyChain(0)
    for tag, step in ((C.BEST_LOC, 7), (C.BEST_CL, 9)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(step)
            model = cli_train.create_model_from_args(
                args, override_arch_for_classifier=True, device="cpu")
        ckpt.save_best_model(str(tmp_path / tag), step, model)
    cls, step = cli_train.load_seeder_classifier(args, kc, "cpu")
    assert step == 7
    want = ckpt.load_best_model(str(tmp_path / C.BEST_LOC))[1]
    got = cls.encoder.state_dict()
    for k, v in want["components"]["encoder"].items():
        assert torch.equal(got[k], v), k
    assert not any(p.requires_grad for p in cls.parameters())


UNREAD_FLAGS = {"cb_pretrained_cl_ch_pt": ("best_classification",
                                          "best_localization"),
                "cb_area_normed": ("false", "true"),
                "cb_pp_box_alpha": ("0.1", "0.7"),
                "cb_seed_bg_z_type": ("size_data", "size_constant"),
                "encoder_weights": ("imagenet", "none"),
                "path_pre_trained": ("", "x.pt"),
                "in_channels": ("3", "4"), "seg_mode": ("binary", "multiclass"),
                "strict": ("true", "false"), "save_dir_models": ("", "m"),
                "scale_in": ("1.0", "2.0"),
                # parsed by JAX's get_config and read by no module (its
                # demo CLI takes flags of its own)
                "demo_video": ("false", "true")}


def test_unread_keys_parse_as_jax_and_are_read_nowhere():
    """The keys JAX parses and never reads (UNREAD_KEYS): the port parses
    their defaults, spelled out, as JAX does, and no module of the port
    but the config names them."""
    from tcam_wsol_video_tpu.core.hparams import parse_args as jparse
    from tcam_wsol_video_tpu_torch.core.config import UNREAD_KEYS
    assert set(UNREAD_FLAGS) == set(UNREAD_KEYS)
    flags = ["--task", "C_BOX", "--arch", "DenseBoxNet"]
    for k, (default, _) in UNREAD_FLAGS.items():
        flags += [f"--{k}", default]
    got, want = parse_args(flags)[0], jparse(flags)
    for k in UNREAD_KEYS:
        assert getattr(got, k) == getattr(want, k), k
        assert type(getattr(got, k)) is type(getattr(want, k)), k
    root = os.path.join(REPO, "tcam_wsol_video_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or f == "config.py":
                continue
            with open(os.path.join(dirpath, f)) as fh:
                text = fh.read()
            for k in UNREAD_KEYS:
                # an attribute read; the module path cli.demo_video is not
                # one
                assert not re.search(rf"(?<!cli)\.{k}\b", text), (f, k)


@pytest.mark.parametrize("key", sorted(UNREAD_FLAGS))
def test_unread_keys_refuse_other_values(key):
    """A value other than the default of a key that no module reads is
    refused, so that it cannot seem to change a run; JAX parses it."""
    from tcam_wsol_video_tpu.core.hparams import parse_args as jparse
    base = ["--task", "C_BOX", "--arch", "DenseBoxNet"]
    flags = base + [f"--{key}", UNREAD_FLAGS[key][1]]
    assert getattr(jparse(flags), key) != getattr(jparse(base), key)
    with pytest.raises(ValueError, match=key):
        parse_args(flags)


# ------------------------------------------------------ trainer and CLIs
def _common(root):
    return ["--dataset", "YouTube-Objects-v1.0", "--data_root", root,
            "--metadata_root", os.path.join(root, "folds"),
            "--crop_size", "32", "--resize_size", "40",
            "--cam_curve_interval", "0.05", "--eval_batch_size", "8",
            "--batch_size", "4", "--log_every", "0",
            "--checkpoint_save", "0", "--outd", os.path.join(root, "exps")]


CBOX_FLAGS = ["--task", "C_BOX", "--arch", "DenseBoxNet",
              "--cb_area_box", "true", "--cb_cl_score", "true",
              "--cb_seed", "true", "--cb_pp_box", "true",
              "--cb_seed_n", "4", "--cb_seed_erode_iter", "0",
              "--cb_cl_score_blur_ksize", "9",
              "--cb_cl_score_blur_sigma", "4.0"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from tcam_wsol_video_tpu_torch.data.synthetic import (
        make_stand_in_cam_store, make_synthetic_dataset)
    root = str(tmp_path_factory.mktemp("cbox"))
    out = make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    make_stand_in_cam_store(out["metadata_root"],
                            os.path.join(root, "cam_store"))
    return root


def test_cbox_trainer_epoch_and_evaluator(synth):
    """The trainer's C_BOX epoch (finite loss terms, a valid-box share,
    one step a dispatch) and its evaluation of the predicted boxes."""
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args
    args, _ = parse_args(_common(synth) + CBOX_FLAGS + [
        "--std_cams_folder", os.path.join(synth, "cam_store"),
        "--max_epochs", "1", "--lr", "0.01", "--compute_dtype", "float32",
        "--exp_id", "trainer"])
    kc = KeyChain(0)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, "cpu")
    model = create_model_from_args(args, device="cpu")
    cls, _ = cli_train.load_seeder_classifier(args, kc, "cpu")
    trainer = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                      device="cpu", classifier=cls)
    rec = trainer.train_epoch(0)
    assert np.isfinite(rec["loss"]) and rec["dispatch"] == "per_step"
    assert sorted(rec["terms"]) == ["area_box", "box_bounds", "cl_scoring",
                                    "seed_cbox"]
    assert all(np.isfinite(v) for v in rec["terms"].values())
    assert 0.0 <= rec["valid_box_share"] <= 1.0
    res = trainer.evaluate(0, C.VALIDSET)
    assert 0.0 <= res["localization"] <= 100.0
    assert res["timing"]["sweep"] == "bbox"
    assert res["n_images"] == len(eval_pipes[C.VALIDSET][0])
    with pytest.raises(ValueError):
        Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                device="cpu")


def test_cbox_through_the_clis(synth):
    """STD_CL stage 1, then --config config_yaml/ytov1_cbox.yaml with the
    stage-1 folder (DenseBoxNet takes its encoder alone), then evaluate on
    the best-localization snapshot, equal to the trainer's test pass."""
    cpu = ["--device", "cpu"]
    s1 = cli_train.main(_common(synth) + [
        "--task", "STD_CL", "--max_epochs", "1", "--lr", "0.01",
        "--exp_id", "s1"] + cpu)
    loaded = {}
    load = ckpt.load_components

    def spy(model, components, only=None):
        loaded.setdefault(type(model).__name__, []).append(only)
        load(model, components, only)
    mp = pytest.MonkeyPatch()
    mp.setattr(ckpt, "load_components", spy)
    try:
        res = cli_train.main(
            _common(synth) + ["--config", CBOX_YAML]
            + CBOX_FLAGS[4:] + [
                "--std_cams_folder", os.path.join(synth, "cam_store"),
                "--folder_pre_trained_cl", s1["outd"], "--max_epochs", "1",
                "--exp_id", "cb"] + cpu)
    finally:
        mp.undo()
    assert loaded["DenseBoxNet"] == [["encoder"]]
    assert loaded["STDClassifier"] == [["encoder", "classification_head"]]
    assert res["args"].task == C.C_BOX and res["seeder_step"] is not None
    test = res["test"][C.BEST_LOC]
    for k in ("localization", "maxboxacc_50", "classification"):
        assert np.isfinite(test[k]), k
    out = cli_evaluate.main(_common(synth) + CBOX_FLAGS + [
        "--folder_pre_trained_cl", s1["outd"], "--exp_dir", res["outd"],
        "--split", "test"] + cpu)
    for s in (30, 50, 70):
        assert out[f"maxboxacc_{s}"] == test[f"maxboxacc_{s}"], s
    assert out["classification"] == test["classification"]
