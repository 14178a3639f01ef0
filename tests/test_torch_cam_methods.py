"""Port parity of the thirteen CAM methods (cams/extractors.py and the
STD_CL eval step's dispatch, engine/steps.py) against the JAX package's
extractors and its make_cam_eval_step, on a tiny STDClassifier: one
strided 3x3 convolution to 32 channels (so the ScoreCAM family scores one
chunk of 32 channels per sample) and each pooling head, weights
transplanted from flax, fp32 on the CPU.  The noise of SmoothGradCAM++
and SSCAM is drawn once in numpy and injected on both sides (into JAX's
eval step through jax.random.normal).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tcam_wsol_video_tpu.cams import extractors as jex
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.engine.steps import make_cam_eval_step as jeval
from tcam_wsol_video_tpu.models.classifier import \
    STDClassifier as JSTDClassifier
from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import finalize, stage1_cam_recipe
from tcam_wsol_video_tpu_torch.engine.steps import make_cam_eval_step
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import Conv2d
from tcam_wsol_video_tpu_torch.models.transplant import load_flax_variables

torch.set_num_threads(1)

# the normalized maps in [0, 1], absolute: fp32 on both sides, summed in
# another order
ATOL = 1e-4
CROP, CH, CLASSES, B = 32, 32, 10, 2
SAMPLES = {"sgcampp_num_samples": 3, "sscam_num_samples": 2,
           "iscam_num_samples": 3}
STD = {C.METHOD_SMOOTHGRADCAMPP: 0.3, C.METHOD_SSCAM: 2.0}


class JTinyEncoder(fnn.Module):
    """[x, relu(conv 3x3 / 4)] (NHWC)."""
    dtype: object = jnp.float32
    out_channels = (3, CH)

    @fnn.compact
    def __call__(self, x, train: bool = False):
        y = fnn.Conv(CH, (3, 3), strides=(4, 4), padding=1,
                     dtype=self.dtype, name="conv")(x)
        return [x, fnn.relu(y)]


class TinyEncoder(nn.Module):
    out_channels = (3, CH)

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, CH, 3, stride=4, padding=1)

    def forward(self, x, dtype=torch.float32, generator=None):
        return [x, torch.relu(self.conv(x.to(dtype)))]


def _models(pooling: str, seed: int = 0):
    jm = JSTDClassifier(encoder=JTinyEncoder(), pooling=pooling,
                        classes=CLASSES)
    x = jnp.zeros((1, CROP, CROP, 3), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), x))
    tm = STDClassifier(TinyEncoder(), pooling, CLASSES)
    load_flax_variables(tm, variables)
    return jm, variables, tm.eval()


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    return x, y


def _noise(method, seed: int = 2):
    n = SAMPLES["sgcampp_num_samples" if method == C.METHOD_SMOOTHGRADCAMPP
                else "sscam_num_samples"]
    return np.random.default_rng(seed).standard_normal(
        (n, B, CROP, CROP, 3)).astype(np.float32)


def _close(got: torch.Tensor, want, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= ATOL, f"{what}: {err:.3e} > {ATOL}"


def _pooling(method):
    return C.METHOD_2_POOLINGHEAD[method]


@pytest.mark.parametrize("method", C.CAM_METHODS)
def test_extractor_matches_jax(method):
    """Each method's extractor on the model's own features (and, for the
    methods that need them, its head and its forward)."""
    jm, v, tm = _models(_pooling(method))
    x, y = _inputs()
    jout = jm.apply(v, x)
    with torch.no_grad():
        tout = tm(torch.from_numpy(x))
    jf, tf = jout["features"][-1], tout["features"][-1]
    jy, ty = jnp.asarray(y), torch.from_numpy(y).long()

    def jhead(f):
        return jm.apply(v, f, method="head_from_features")[0]

    def thead(f):
        return tm.head_from_features(f)[0]

    def jfeats(im):
        return jm.apply(v, im)["features"][-1]

    def tfeats(im):
        return tm(im)["features"][-1]

    def jlogits(im):
        return jm.apply(v, im)["cl_logits"]

    def tlogits(im):
        return tm(im)["cl_logits"]

    tx = torch.from_numpy(x)
    with torch.no_grad():
        if method == C.METHOD_CAM:
            want = jex.cam_fc_weights(jf, v["params"]["classification_head"]
                                      ["fc"]["kernel"], jy)
            got = ex.cam_fc_weights(tf, tm.classification_head.fc.weight,
                                    ty)
        elif method in ex.BUILTIN_CAM_METHODS:
            want = jex.builtin_cam(jout["cams_head"], jy)
            got = ex.builtin_cam(tout["cams_head"], ty)
        elif method == C.METHOD_SMOOTHGRADCAMPP:
            noise = 0.3 * _noise(method)
            want = jex.smooth_grad_cam_pp(jfeats, jhead, x, jy, None,
                                          noise=noise)
            got = ex.smooth_grad_cam_pp(tfeats, thead, tx, ty,
                                        noise=torch.from_numpy(noise))
        elif method == C.METHOD_SCORECAM:
            want = jex.score_cam(jlogits, x, jf, jy)
            got = ex.score_cam(tlogits, tx, tf, ty)
        elif method == C.METHOD_SSCAM:
            noise = 2.0 * _noise(method)
            want = jex.sscam(jlogits, x, jf, jy, None, noise=noise)
            got = ex.sscam(tlogits, tx, tf, ty,
                           noise=torch.from_numpy(noise))
        elif method == C.METHOD_ISCAM:
            want = jex.iscam(jlogits, x, jf, jy, num_samples=3)
            got = ex.iscam(tlogits, tx, tf, ty, num_samples=3)
        else:
            want = jex.build_std_extractor(method)(jhead, jf, jy)
            got = ex.build_std_extractor(method)(thead, tf, ty)
    assert got.shape == (B, CROP // 4, CROP // 4)
    _close(got, want, method)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_gradcampp_corrected_alpha_matches_jax():
    jm, v, tm = _models(C.WGAP)
    x, y = _inputs(5)
    jf = jm.apply(v, x)["features"][-1]
    with torch.no_grad():
        tf = tm(torch.from_numpy(x))["features"][-1]
    want = jex.grad_cam_pp(
        lambda f: jm.apply(v, f, method="head_from_features")[0], jf,
        jnp.asarray(y), corrected_alpha=True)
    got = ex.grad_cam_pp(lambda f: tm.head_from_features(f)[0], tf,
                         torch.from_numpy(y).long(), corrected_alpha=True)
    _close(got, want, "corrected alpha")


def _args(method):
    targs = finalize(stage1_cam_recipe(
        crop_size=CROP, method=method, spatial_pooling=_pooling(method),
        compute_dtype="float32"))
    cfg = get_config(JC.YTOV1)
    cfg.update(dict(targs.__dict__))
    cfg.update(SAMPLES)
    for k, val in SAMPLES.items():
        setattr(targs, k, val)
    return targs, HParams(cfg)


@pytest.mark.parametrize("method", C.CAM_METHODS)
def test_eval_step_dispatch_matches_jax(method, monkeypatch):
    """The STD_CL eval step of each method (the CAM at the crop, the
    logits) against JAX's make_cam_eval_step on the same model, images
    and labels; the noise methods get the same unit normal draws (JAX's
    through jax.random.normal, times its std; the port's as `noise`)."""
    jm, v, tm = _models(_pooling(method))
    x, y = _inputs(3)
    targs, jargs = _args(method)
    noise = None
    if method in STD:
        unit = _noise(method)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(
                                unit, dtype))
        noise = torch.from_numpy(STD[method] * unit)
    want_cam, want_logits = jeval(jm, jargs)(
        v["params"], {}, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    got_cam, got_logits = make_cam_eval_step(tm, targs)(
        torch.from_numpy(x), targets=torch.from_numpy(y).long(),
        noise=noise)
    assert got_cam.shape == (B, CROP, CROP)
    _close(got_cam, want_cam, method)
    _close(got_logits, want_logits, "logits")
    assert all(p.grad is None for p in tm.parameters())
    assert targs.std_cl_method_requires_grad == (
        method in (C.METHOD_GRADCAM, C.METHOD_GRADCAMPP,
                   C.METHOD_SMOOTHGRADCAMPP, C.METHOD_XGRADCAM,
                   C.METHOD_LAYERCAM))


@pytest.mark.parametrize("method", [C.METHOD_SMOOTHGRADCAMPP,
                                    C.METHOD_SSCAM])
def test_noise_methods_draw_from_the_generator_only(method):
    _, _, tm = _models(_pooling(method))
    x, y = _inputs(4)
    targs, _ = _args(method)
    step = make_cam_eval_step(tm, targs)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    with pytest.raises(ValueError, match="noise"):
        step(xt, targets=yt)
    state = torch.get_rng_state()
    a, _ = step(xt, targets=yt, generator=torch.Generator().manual_seed(9))
    b, _ = step(xt, targets=yt, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and torch.equal(torch.get_rng_state(), state)
