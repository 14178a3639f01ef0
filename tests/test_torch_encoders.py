"""Port parity of the VGG16, InceptionV3 and ResNet-101 encoders
(models/vgg.py, models/inception.py, models/resnet.py) against the JAX
package's, as STDClassifiers with a GAP head on weights transplanted from
flax: every stage feature and the logits in inference mode (BN running
statistics) and in training mode (batch statistics, and the running
statistics' update), at fp32 and at bf16 (the JAX model built at
compute_dtype bfloat16).  InceptionV3's SPG dropout is live in training:
both sides apply the same numpy-drawn masks (torch_port_fixtures.SpgMasks).
Also the ceil-mode max pool against JAX's asymmetric padding, and the
transplant's coverage of every leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (SpgMasks, assert_close, images,
                                 jax_std_classifier, jax_variables,
                                 torch_std_classifier)
from tcam_wsol_video_tpu.models import inception as jinc
from tcam_wsol_video_tpu_torch.models import inception as tinc
from tcam_wsol_video_tpu_torch.models.factory import get_encoder
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict

torch.set_num_threads(1)

# fp32 conv/BN chains summed in another order, relative to the largest
# entry
FWD_RTOL = 1e-4
BN_RTOL = 1e-4
# bf16: tests/test_torch_dtype.py's bounds (12 bf16 steps for the
# features, one for the running statistics)
BF16_EPS = 2.0 ** -8
BF16_FWD_RTOL = 12 * BF16_EPS
BF16_BN_RTOL = BF16_EPS
# bf16 in training mode, the deep BN encoders past the stage where a
# rounding flip has grown beyond BF16_FWD_RTOL: batch statistics of 2 x
# 4x4 maps amplify each flip, so JAX's own bf16 output lies 80-200 bf16
# steps from its fp32 output (measured); the port's must lie no further
# from JAX's fp32 output than JAX's bf16 does, up to this factor, plus
# BF16_FWD_RTOL
BF16_TRAIN_GAP_FACTOR = 1.25
ENCODERS = ("vgg16", "inceptionv3", "resnet101")
B = 2


@pytest.fixture(scope="module", params=ENCODERS)
def encoder(request):
    jm = jax_std_classifier(request.param, "GAP")
    return request.param, jax_variables(jm, seed=7)


def _run(name, variables, dtype, train, monkeypatch):
    """(JAX's output, its BN update, the port's output, the port's model)
    on the same images; dtype float32, bfloat16 or float64 (JAX under
    enable_x64, the port in double)."""
    x = images(np.random.default_rng(11), B)
    masks = SpgMasks(monkeypatch, seed=3) if train else None
    jdtype = getattr(jnp, dtype)
    with jax.enable_x64(dtype == "float64"):
        jm = jax_std_classifier(name, "GAP", dtype=jdtype)
        jv = variables
        if dtype == "float64":
            jv = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jdtype),
                                        variables)
            x = x.astype(np.float64)
        if train:
            want, upd = jm.apply(jv, x, train=True,
                                 mutable=["batch_stats"])
        else:
            want, upd = jm.apply(jv, x, train=False), None
        want = jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), want)
    tm = torch_std_classifier(variables, name, "GAP").train(train)
    if dtype == "float64":
        tm = tm.double()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), getattr(torch, dtype))
    if masks is not None and name == "inceptionv3":
        assert len(masks.masks) == 2 and masks._torch_i == 2
    return want, upd, got, tm


def _nhwc(feats):
    return [f.permute(0, 2, 3, 1).double().numpy() for f in feats]


def _check_bn_update(variables, upd, tm, rtol, ref_upd=None):
    """The port's running statistics against JAX's update, within rtol;
    with ref_upd (JAX's fp32 update) a statistic past that tolerance is
    held to the bf16 training rule of the features instead."""
    def sd_of(u):
        return flax_to_state_dict({"params": variables["params"],
                                   "batch_stats": u["batch_stats"]})
    new = sd_of(upd)
    ref = sd_of(ref_upd) if ref_upd is not None else None
    sd = tm.state_dict()
    stats = [k for k in new if "running_" in k]
    assert stats
    for k in stats:
        g, w = sd[k].double().numpy(), np.asarray(new[k], np.float64)
        scale = np.abs(w).max()
        if ref is None or np.abs(g - w).max() <= rtol * scale:
            assert_close(g, w, rtol, k)
            continue
        r = np.asarray(ref[k], np.float64)
        assert (np.abs(g - r).max() <= BF16_TRAIN_GAP_FACTOR
                * np.abs(w - r).max() + rtol * scale), k


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_fp32_matches_jax(encoder, train, monkeypatch):
    """fp32 on both sides; ResNet-101 in training mode in float64: its
    ~100 BN layers on batch statistics of 2 x 4x4 maps amplify the
    cancellation of flax's one-pass variance to 1.5e-3 of the last
    feature at fp32 (measured; test_torch_stage1 meets the same), which
    float64 removes."""
    name, variables = encoder
    dtype = "float64" if (train and name == "resnet101") else "float32"
    want, upd, got, tm = _run(name, variables, dtype, train, monkeypatch)
    assert len(got["features"]) == len(want["features"])
    for i, (g, w) in enumerate(zip(_nhwc(got["features"]),
                                   want["features"])):
        assert_close(g, w, FWD_RTOL, f"{name} feature {i}")
    assert_close(got["cl_logits"].double().numpy(), want["cl_logits"],
                 FWD_RTOL, "logits")
    if train and name != "vgg16":
        _check_bn_update(variables, upd, tm, BN_RTOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_bf16_matches_jax(encoder, train, monkeypatch):
    """The JAX model built at bfloat16 against the port at bfloat16, from
    the same fp32 parameters."""
    name, variables = encoder
    want, upd, got, tm = _run(name, variables, "bfloat16", train,
                              monkeypatch)
    ref = ref_upd = None
    if train and name != "vgg16":
        ref, ref_upd, _, _ = _run(name, variables, "float32", train,
                                  monkeypatch)
    feats = _nhwc(got["features"])
    for i, (g, w) in enumerate(zip(feats, want["features"])):
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        if ref is None or err <= BF16_FWD_RTOL * scale:
            assert_close(g, w, BF16_FWD_RTOL, f"{name} feature {i}")
            continue
        # past the chaotic stage: the port's bf16 no further from JAX's
        # fp32 output than JAX's bf16 is
        r = ref["features"][i]
        jgap = np.abs(w - r).max()
        tgap = np.abs(g - r).max()
        assert i >= 4, (name, i, err / scale)
        assert tgap <= BF16_TRAIN_GAP_FACTOR * jgap + BF16_FWD_RTOL * scale, (
            name, i, tgap / scale, jgap / scale)
    if ref is None:
        assert_close(got["cl_logits"].double().numpy(), want["cl_logits"],
                     BF16_FWD_RTOL, "logits")
    if train and name != "vgg16":
        _check_bn_update(variables, upd, tm, BF16_BN_RTOL, ref_upd)


def test_transplant_maps_every_leaf(encoder):
    name, variables = encoder
    sd = flax_to_state_dict(variables)
    own = torch_std_classifier(variables, name, "GAP").state_dict()
    assert set(sd) == {k for k in own
                       if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("n", [8, 9, 16, 17, 28, 29, 56, 57, 112])
def test_ceil_max_pool_matches_jax_padding(n):
    x = np.random.default_rng(n).standard_normal((2, n, n, 3)).astype(
        np.float32)
    want = np.asarray(jinc._ceil_max_pool_3x3_s2(jnp.asarray(x)))
    got = tinc.ceil_max_pool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape[1] == n // 2 + 1
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_published_shapes_at_224():
    """The features' channels and sizes of the published architectures
    at 224 px (channels from out_channels, sizes by shape inference)."""
    want = {"vgg16": [(64, 224), (128, 112), (256, 56), (1024, 28)],
            "inceptionv3": [(3, 224), (64, 112), (80, 57), (288, 29),
                            (768, 29), (1024, 29)],
            "resnet101": [(3, 224), (64, 112), (256, 56), (512, 28),
                          (1024, 28), (2048, 28)]}
    for name, shapes in want.items():
        with torch.device("meta"):
            enc = get_encoder(name).eval()
        feats = enc(torch.empty((1, 3, 224, 224), device="meta"))
        assert [(f.shape[1], f.shape[2]) for f in feats] == shapes, name
        assert tuple(c for c, _ in shapes) == enc.out_channels, name
        if name == "resnet101":
            assert sum(1 for n in enc.state_dict()
                       if n.startswith("layer3_")
                       and n.endswith("conv1.weight")) == 23
