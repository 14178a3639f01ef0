"""Shared builders for the port's parity tests (tests/test_torch_*.py):
a small UnetTCAM, or a small STDClassifier, on both sides with the same
weights."""
import jax
import jax.numpy as jnp
import numpy as np

from tcam_wsol_video_tpu.models.classifier import \
    STDClassifier as JSTDClassifier
from tcam_wsol_video_tpu.models.resnet import ResNetWSOL as JResNetWSOL
from tcam_wsol_video_tpu.models.unet import UnetTCAM as JUnetTCAM
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
from tcam_wsol_video_tpu_torch.models.transplant import load_flax_variables
from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM

LAYERS = (1, 1, 1, 1)
CLASSES = 10
CROP = 32


def jax_model(freeze_cl: bool = True, dtype=jnp.float32,
              im_rec: bool = False, img_range: float = 1.0) -> JUnetTCAM:
    """The small UnetTCAM (UnetFCAM) computing in `dtype` (fp32
    parameters), with the reconstruction head when im_rec."""
    return JUnetTCAM(encoder=JResNetWSOL(layers=LAYERS, dtype=dtype),
                     pooling="WGAP", classes=CLASSES, freeze_cl=freeze_cl,
                     im_rec=im_rec, img_range=img_range, dtype=dtype)


def jax_variables(model, seed: int = 0, crop: int = CROP) -> dict:
    """flax init, then BN statistics drawn from numpy so that inference
    mode exercises them (init leaves mean 0 / var 1)."""
    x = jnp.zeros((1, crop, crop, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, x, train=False))(
        jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if "batch_stats" not in variables:     # VGG: no BatchNorm
        return {"params": variables["params"]}
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0.0, 0.1, v.shape)
                         if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, v.shape)
                         ).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def jax_classifier(dtype=jnp.float32) -> JSTDClassifier:
    """The small STDClassifier computing in `dtype` (fp32 parameters)."""
    return JSTDClassifier(encoder=JResNetWSOL(layers=LAYERS, dtype=dtype),
                          pooling="WGAP", classes=CLASSES, dtype=dtype)


def torch_classifier(variables: dict) -> STDClassifier:
    model = STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES)
    load_flax_variables(model, variables)
    return model


def torch_model(variables: dict, freeze_cl: bool = True,
                im_rec: bool = False, img_range: float = 1.0) -> UnetTCAM:
    model = UnetTCAM(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES,
                     freeze_cl=freeze_cl, im_rec=im_rec, img_range=img_range)
    load_flax_variables(model, variables)
    return model


def images(rng: np.random.Generator, b: int) -> np.ndarray:
    return rng.standard_normal((b, CROP, CROP, 3)).astype(np.float32)


def assert_close(got, want, rtol: float, what: str = "") -> None:
    """max |got - want| <= rtol * max |want| (scale-relative)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


def jax_std_classifier(encoder: str, pooling: str = "WGAP",
                       dtype=jnp.float32, **head_kw) -> JSTDClassifier:
    """JAX's STDClassifier on one of its published encoders."""
    from tcam_wsol_video_tpu.models.factory import get_encoder
    return JSTDClassifier(encoder=get_encoder(encoder, dtype=dtype),
                          pooling=pooling, classes=CLASSES, dtype=dtype,
                          **head_kw)


JAX_HEAD_KEYS = {"lse_r": "r", "wc_modalities": "modalities",
                 "wc_kmax": "kmax", "wc_kmin": "kmin", "wc_alpha": "alpha",
                 "wc_dropout": "dropout"}


def torch_std_classifier(variables: dict, encoder: str,
                         pooling: str = "WGAP", **head_kw) -> STDClassifier:
    """The port's STDClassifier with `variables` transplanted; head_kw in
    JAX's spelling (lse_r, wc_*, support_background)."""
    from tcam_wsol_video_tpu_torch.models.factory import get_encoder
    kw = {JAX_HEAD_KEYS.get(k, k): v for k, v in head_kw.items()}
    model = STDClassifier(get_encoder(encoder), pooling, CLASSES, **kw)
    load_flax_variables(model, variables)
    return model


class SpgMasks:
    """Monkeypatches both packages' InceptionV3 dropout so that its n-th
    call applies the n-th keep mask drawn here in numpy: JAX's
    nn.Dropout inside models/inception.py (NHWC) and the port's
    models/inception.dropout (NCHW, the same mask transposed).  The JAX
    package itself is not edited."""

    def __init__(self, monkeypatch, seed: int, rate: float = 0.5):
        import flax.linen as fnn

        import tcam_wsol_video_tpu.models.inception as jinc
        import tcam_wsol_video_tpu_torch.models.inception as tinc
        self.rng = np.random.default_rng(seed)
        self.rate = rate
        self.masks = []          # NHWC keep masks, in draw order
        self._jax_i = self._torch_i = 0
        outer = self

        class _Dropout:
            def __init__(self, rate, deterministic=False):
                self.rate, self.det = rate, deterministic

            def __call__(self, x):
                if self.det:
                    return x
                keep = outer._mask(outer._jax_i, x.shape)
                outer._jax_i += 1
                return jnp.where(keep, x / (1.0 - self.rate),
                                 jnp.zeros((), x.dtype))

        class _NN:
            Dropout = _Dropout

            def __getattr__(self, name):
                return getattr(fnn, name)

        def _torch_dropout(x, p, generator):
            import torch
            keep = outer._mask(outer._torch_i, (x.shape[0],) + tuple(
                x.shape[2:]) + (x.shape[1],))
            outer._torch_i += 1
            keep = torch.from_numpy(keep).permute(0, 3, 1, 2)
            return torch.where(keep, x / (1.0 - p),
                               torch.zeros((), dtype=x.dtype))

        monkeypatch.setattr(jinc, "nn", _NN())
        monkeypatch.setattr(tinc, "dropout", _torch_dropout)

    def _mask(self, i: int, shape) -> np.ndarray:
        while len(self.masks) <= i:
            self.masks.append(None)
        if self.masks[i] is None:
            self.masks[i] = self.rng.random(shape) >= self.rate
        return self.masks[i]
