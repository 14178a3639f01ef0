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


def jax_variables(model, seed: int = 0) -> dict:
    """flax init, then BN statistics drawn from numpy so that inference
    mode exercises them (init leaves mean 0 / var 1)."""
    x = jnp.zeros((1, CROP, CROP, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, x, train=False))(
        jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
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
