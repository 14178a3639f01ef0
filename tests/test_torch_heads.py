"""Port parity of the pooling heads (models/poolings.py): GAP, WGAP,
MaxPool, LogSumExpPool and WildCatCLHead, with and without the background
class, against the JAX package's heads on the same features and
transplanted weights (logits and maps, fp32); _wildcat_k over int and
float k; and WildCat's dropout in training, checked statistically (keep
rate, 1 / (1 - p) scale, the generator's stream only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import assert_close
from tcam_wsol_video_tpu.models import poolings as jpool
from tcam_wsol_video_tpu_torch.models import poolings
from tcam_wsol_video_tpu_torch.models.resnet import dropout
from tcam_wsol_video_tpu_torch.models.transplant import load_flax_variables

torch.set_num_threads(1)

# one 1x1 convolution and a pooling in fp32, relative to the largest
# entry
RTOL = 1e-5
C_IN, CLASSES, B, H = 16, 5, 3, 7

HEADS = [("GAP", {}), ("WGAP", {}), ("MaxPool", {}),
         ("LogSumExpPool", {"r": 10.0}), ("LogSumExpPool", {"r": 3.0}),
         ("WildCatCLHead", {}),
         ("WildCatCLHead", {"modalities": 3, "kmax": 4, "kmin": 2}),
         ("WildCatCLHead", {"kmax": 1.0}), ("WildCatCLHead", {"kmax": 1})]


def _pair(name, kw, bg, seed=0):
    jh = jpool.build_pooling_head(name, CLASSES, bg, **kw)
    x = np.random.default_rng(seed).standard_normal(
        (B, H, H, C_IN)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jh.init(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    th = poolings.build_pooling_head(name, C_IN, CLASSES,
                                     support_background=bg, **kw)
    load_flax_variables(th, variables)
    return jh, variables, th, x


@pytest.mark.parametrize("bg", [False, True], ids=["fg", "bg"])
@pytest.mark.parametrize("name,kw", HEADS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(HEADS)])
def test_head_matches_jax(name, kw, bg):
    jh, variables, th, x = _pair(name, kw, bg)
    jl, jmaps = jh.apply(variables, jnp.asarray(x))
    tl, tmaps = th.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tl.shape == (B, CLASSES)
    assert_close(tl.detach().numpy(), np.asarray(jl), RTOL, "logits")
    if name == "WGAP":
        assert tmaps is None and jmaps is None
        return
    assert not tmaps.requires_grad
    assert tmaps.shape == (B, CLASSES + int(bg), H, H)
    assert_close(tmaps.permute(0, 2, 3, 1).numpy(), np.asarray(jmaps), RTOL,
                 "maps")


def test_maps_keep_the_input_dtype():
    th = poolings.build_pooling_head("GAP", C_IN, CLASSES)
    x = torch.randn(B, C_IN, H, H, dtype=torch.bfloat16)
    logits, maps = th(x)
    assert logits.dtype == maps.dtype == torch.bfloat16


@pytest.mark.parametrize("k", [0, -1, 0.25, 0.5, 0.999, 1, 1.0, 2, 2.0, 7,
                               49, 50, 60.0])
@pytest.mark.parametrize("n", [1, 49, 784])
def test_wildcat_k_matches_jax(k, n):
    got = poolings._wildcat_k(k, n)
    assert got == jpool._wildcat_k(k, n) and type(got) is int


def test_wildcat_k_tells_int_from_float():
    assert poolings._wildcat_k(1, 49) == 1
    assert poolings._wildcat_k(1.0, 49) == 49


def test_unknown_head_raises():
    with pytest.raises(ValueError):
        poolings.build_pooling_head("nope", C_IN, CLASSES)


def test_dropout_keep_rate_and_scale():
    """Binomial keep rate within 5 standard deviations; kept entries
    scaled by exactly 1 / (1 - p); the draws come from the generator
    alone (the global stream untouched; the same seed, the same mask)."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    state = torch.get_rng_state()
    y = dropout(x, p, torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), state)
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    assert torch.all(y[kept] == 1.0 / (1.0 - p))
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(1)))
    assert torch.equal(dropout(x, 0.0, None), x)
    with pytest.raises(ValueError):
        dropout(x, p, None)


def test_wildcat_dropout_in_training():
    """WildCat drops sorted activations in training only: with kmax = all
    (float 1.0) its train score is an unbiased estimate of the eval score
    (mean over draws within 5 standard errors); eval mode draws nothing."""
    p = 0.5
    th = poolings.build_pooling_head("WildCatCLHead", C_IN, CLASSES,
                                     kmax=1.0, dropout=p)
    x = torch.randn(B, C_IN, H, H)
    with torch.no_grad():
        want = th.eval()(x)[0]
        th.train()
        g = torch.Generator().manual_seed(0)
        draws = torch.stack([th(x, g)[0] for _ in range(400)])
        assert torch.equal(th.eval()(x)[0], want)
    mean = draws.mean(0)
    se = draws.std(0) / 400 ** 0.5
    assert torch.all((mean - want).abs() < 5 * se + 1e-6)
    assert not torch.equal(draws[0], draws[1])
    with pytest.raises(ValueError):
        th.train()(x)


@pytest.mark.parametrize("source,want", [
    (["--wc_kmax", "1"], 1.0), (["--wc_kmax", "0.3"], 0.3),
    ("wc_kmax: 1\n", 1), ("wc_kmax: 1.0\n", 1.0),
    ("wc_kmin: 2\n", 2)], ids=["argv_1", "argv_frac", "yaml_int",
                                "yaml_float", "yaml_kmin"])
def test_wildcat_k_types_through_argv_and_yaml(source, want, tmp_path):
    """As JAX's parse_args: a flag takes the type of the key's value so
    far (wc_kmax's float default), a yaml value keeps YAML's type; so
    _wildcat_k sees an int 1 only from a yaml."""
    from tcam_wsol_video_tpu.core.hparams import parse_args as jparse
    from tcam_wsol_video_tpu_torch.core.config import parse_args
    argv = source
    if isinstance(source, str):
        path = tmp_path / "c.yaml"
        path.write_text(source)
        argv = ["--config", str(path)]
    got, _ = parse_args(argv)
    jgot = jparse(argv)
    key = "wc_kmin" if "wc_kmin" in str(source) else "wc_kmax"
    assert getattr(got, key) == getattr(jgot, key) == want
    assert type(getattr(got, key)) is type(getattr(jgot, key)) is type(want)
