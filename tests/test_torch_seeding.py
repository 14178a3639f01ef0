"""Port parity: the TCAM seeder and its ops (morphology, device Otsu).

torch cannot reproduce jax.random, so the Gumbel noise of the JAX seeder
is derived outside it with the seeder's own key splits (one key per image
from jax.random.split(key, B), then (kf, kb) = split(that key)) and handed
to the port's seeder: the seed masks must then be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.cams.seeding import tcam_seeder as jseeder
from tcam_wsol_video_tpu.ops import morphology as jmorph
from tcam_wsol_video_tpu.ops import otsu as jotsu
from tcam_wsol_video_tpu_torch.cams.seeding import TCAMSeederCfg, tcam_seeder
from tcam_wsol_video_tpu_torch.ops import morphology, otsu

torch.set_num_threads(1)


def jax_gumbel(key, b: int, p: int) -> np.ndarray:
    """(B, 2, P) fg/bg Gumbel draws exactly as the JAX seeder makes them."""
    out = []
    for k in jax.random.split(key, b):
        kf, kb = jax.random.split(k)
        out.append([np.asarray(jax.random.gumbel(kf, (p,), jnp.float32)),
                    np.asarray(jax.random.gumbel(kb, (p,), jnp.float32))])
    return np.asarray(out, np.float32)


CASES = {
    # the stage-2 recipe: 1/1 seeds, 3x3 dilation, weighted, inside the ROI
    "recipe": dict(seed_tech="seed_weighted", min_=1, max_=1, min_p=0.1,
                   max_p=0.6, ksz=3, use_roi=True),
    "defaults_uniform": dict(),
    # k > 32: the bisection top-k path
    "bisect_topk": dict(seed_tech="seed_weighted", min_=40, max_=40,
                        min_p=0.3, max_p=0.3, ksz=1, use_roi=True),
    "eroded_roi_even_ksz": dict(min_=5, max_=5, ksz=2, use_roi=True,
                                fg_erode_iter=1, fg_erode_k=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_masks_equal_with_injected_noise(case):
    kw = CASES[case]
    rng = np.random.default_rng(5)
    b, h, w = 4, 20, 24
    cams = rng.random((b, h, w)).astype(np.float32)
    cams[2] = 0.5                                  # degenerate: no seeds
    roi = (rng.random((b, h, w)) > 0.4).astype(np.int32)
    key = jax.random.PRNGKey(11)
    jcfg = JCfg(**kw)
    use_roi = jcfg.use_roi
    want = np.asarray(jax.jit(
        lambda k, c, r: jseeder(k, c, jcfg, roi=r if use_roi else None))(
            key, jnp.asarray(cams), jnp.asarray(roi)))
    got = tcam_seeder(torch.from_numpy(cams), TCAMSeederCfg(**kw),
                      roi=torch.from_numpy(roi) if use_roi else None,
                      gumbel=torch.from_numpy(jax_gumbel(key, b, h * w)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[2] == jcfg.seg_ignore_idx).all()
    assert (want == 1).any() and (want == 0).any()


def test_seeder_draws_from_generator():
    rng = np.random.default_rng(6)
    cams = torch.from_numpy(rng.random((2, 16, 16)).astype(np.float32))
    cfg = TCAMSeederCfg(min_=3, max_=3)
    a = tcam_seeder(cams, cfg, generator=torch.Generator().manual_seed(1))
    b = tcam_seeder(cams, cfg, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((a == 1).sum((1, 2)) > 0).all() and ((a == 0).sum((1, 2)) > 0).all()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_morphology_matches_jax(k):
    rng = np.random.default_rng(k)
    x = (rng.random((2, 9, 11)) > 0.7).astype(np.int32)
    np.testing.assert_array_equal(
        morphology.dilate(torch.from_numpy(x), k).numpy(),
        np.asarray(jmorph.dilate(jnp.asarray(x), k)))
    xf = rng.random((2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        morphology.erode(torch.from_numpy(xf), k, 2).numpy(),
        np.asarray(jmorph.erode(jnp.asarray(xf), k, 2)))


def test_device_otsu_matches_jax():
    rng = np.random.default_rng(8)
    cams = rng.random((3, 14, 14)).astype(np.float32) ** 2
    cams[1] = 0.25
    got = otsu.otsu_threshold_batch(torch.from_numpy(cams)).numpy()
    want = np.asarray(jotsu.otsu_threshold_batch(jnp.asarray(cams)))
    np.testing.assert_array_equal(got, want)
