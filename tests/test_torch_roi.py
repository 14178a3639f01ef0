"""Port parity: the ROI chain on tensors (skimage Otsu, min-propagation
labels, component slots, covering boxes, roi_batch for every method), its
host route roi_one_cam_np, and the temporal CAM fusion, against the JAX
package on the CPU.

The tensor route must equal JAX's bit for bit: thresholds, labels, slots,
areas, masses, ROIs, masks and boxes.  The inputs are CAMs made from a
numpy seed: smooth multi-blob maps, noise, a constant map, an empty ROI
(a stored threshold above 255), a map of more than 64 components, and a
serpentine longer than the 128 propagation steps.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from tcam_wsol_video_tpu.cams import roi as jroi
from tcam_wsol_video_tpu.cams import temporal as jtemporal
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.ops import boxes as jboxes
from tcam_wsol_video_tpu.ops import connected_components as jcc
from tcam_wsol_video_tpu.ops import otsu as jotsu
from tcam_wsol_video_tpu_torch.cams import roi
from tcam_wsol_video_tpu_torch.cams import temporal
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.ops import boxes
from tcam_wsol_video_tpu_torch.ops import connected_components as cc
from tcam_wsol_video_tpu_torch.ops import otsu

torch.set_num_threads(1)

METHODS = (C.ROI_ALL, C.ROI_LARGEST, C.ROI_H_DENSITY)
# heat_cam's exp: XLA's and ATen's exp differ by an ulp or two, and the
# division by the max carries it (values in [0, 1])
HEAT_ATOL = 1e-6


def blob_cams(rng: np.random.Generator, b: int, h: int, w: int
              ) -> np.ndarray:
    """Sums of 1-4 Gaussian blobs of random size and weight, in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = rng.uniform(1.5, max(h, w) / 4)
            out[i] += rng.uniform(0.3, 1.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out[i] /= out[i].max()
    return out


def many_components(h: int = 32, w: int = 32) -> np.ndarray:
    """Isolated bright pixels on a stride-3 grid: 100 components."""
    cam = np.zeros((h, w), np.float32)
    cam[1::3, 1::3] = np.linspace(0.5, 1.0, cam[1::3, 1::3].size,
                                  dtype=np.float32).reshape(
                                      cam[1::3, 1::3].shape)
    return cam


def serpentine(n: int = 32) -> np.ndarray:
    """A one-pixel-wide path through every other row, joined at alternate
    ends: one component whose in-component path is ~n * n / 2 > 128."""
    m = np.zeros((n, n), np.float32)
    m[::2] = 1
    m[1::4, -1] = 1
    m[3::4, 0] = 1
    return m


@pytest.fixture(scope="module")
def cams() -> np.ndarray:
    rng = np.random.default_rng(0)
    smooth = blob_cams(rng, 10, 32, 32)
    noise = rng.random((3, 32, 32)).astype(np.float32) ** 3
    const = np.full((1, 32, 32), 0.4, np.float32)
    return np.concatenate([smooth, noise, const, many_components()[None]])


def _eq(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def test_otsu_skimage255_bit_equal(cams):
    x = np.floor(cams * 255.0)
    want = jax.jit(jax.vmap(jotsu.otsu_threshold_skimage255))(x)
    got = otsu.otsu_threshold_skimage255(torch.from_numpy(x))
    _eq(got, want, "threshold")
    # degenerate: a constant map thresholds at 0
    assert float(got[13]) == 0.0


def test_label_and_component_stats_bit_equal(cams):
    th = jax.vmap(jotsu.otsu_threshold_skimage255)(np.floor(cams * 255.0))
    blobs = (cams * 255.0 >= np.asarray(th)[:, None, None]).astype(np.int32)
    jlab = jax.jit(jax.vmap(jcc.label_jax))(blobs)
    lab = cc.label(torch.from_numpy(blobs))
    _eq(lab, jlab, "labels")
    ja, jm, jc = jax.jit(jax.vmap(jcc.component_stats))(jlab, cams)
    a, m, comp = cc.component_stats(lab, torch.from_numpy(cams))
    _eq(a, ja, "areas")
    _eq(m, jm, "masses")
    _eq(comp, jc, "slots")
    # the grid map has 100 components: 64 get a slot, the rest none
    assert int((a[-1] > 0).sum()) == 64
    assert int((comp[-1] >= 0).sum()) == 64


def test_component_stats_without_background():
    """All foreground: the 65th distinct label merges into the last slot,
    labels past it get none (JAX's jnp.unique(size=65) ranking)."""
    lab = np.arange(1, 81, dtype=np.int32).reshape(1, 8, 10)
    cam = np.random.default_rng(1).random((1, 8, 10)).astype(np.float32)
    ja, jm, jc = jax.vmap(jcc.component_stats)(lab, cam)
    a, m, comp = cc.component_stats(torch.from_numpy(lab).long(),
                                    torch.from_numpy(cam))
    _eq(a, ja, "areas")
    _eq(m, jm, "masses")
    _eq(comp, jc, "slots")
    assert float(a[0, 63]) == 2.0


def test_label_converges_to_scipy_on_blobs(cams):
    """Away from long paths the min labels are scipy's partition."""
    blobs = (cams[:10] > 0.5).astype(np.int32)
    lab = cc.label(torch.from_numpy(blobs)).numpy()
    for i in range(len(blobs)):
        ref = cc.label_np(blobs[i])
        ref_s, _ = ndi.label(blobs[i] > 0, structure=cc._FOUR)
        np.testing.assert_array_equal(ref, ref_s)
        # the same partition: one label of each kind per component
        pairs = {(int(p), int(q)) for p, q in zip(ref.ravel(),
                                                  lab[i].ravel())}
        assert len(pairs) == len(np.unique(ref))


def test_label_caps_at_128_steps_like_jax():
    """On a serpentine longer than 128 steps both packages stop short of
    scipy's one component, with the same labels."""
    m = serpentine(32).astype(np.int32)
    assert ndi.label(m > 0, structure=cc._FOUR)[1] == 1
    lab = cc.label(torch.from_numpy(m)[None])[0]
    _eq(lab, jcc.label_jax(m), "serpentine labels")
    assert len(np.unique(lab.numpy())) > 2


def test_mask_to_bbox_bit_equal(cams):
    masks = (cams > 0.6).astype(np.int32)
    masks[0] = 0
    want = jax.vmap(jboxes.mask_to_bbox)(masks)
    _eq(boxes.mask_to_bbox(torch.from_numpy(masks)), want, "boxes")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stored", [False, True], ids=["otsu", "stored"])
def test_roi_batch_bit_equal(cams, method, stored):
    rng = np.random.default_rng(2)
    threshs = None
    if stored:
        threshs = rng.uniform(60.0, 200.0, len(cams)).astype(np.float32)
        threshs[0] = 300.0          # no blob: the empty ROI
    jm = {C.ROI_ALL: JC.ROI_ALL, C.ROI_LARGEST: JC.ROI_LARGEST,
          C.ROI_H_DENSITY: JC.ROI_H_DENSITY}[method]
    want = jax.jit(lambda c, t: jroi.roi_batch(c, jm, 0.05, threshs=t))(
        cams, threshs) if stored else jax.jit(
        lambda c: jroi.roi_batch(c, jm, 0.05))(cams)
    got = roi.roi_batch(torch.from_numpy(cams), method, 0.05,
                        None if threshs is None else
                        torch.from_numpy(threshs))
    for name, g, w in zip(("roi", "mask", "box"), got, want):
        assert g.dtype == {"roi": torch.int32}.get(name, torch.float32)
        _eq(g, w, name)
    if stored:
        assert int(got[0][0].sum()) == 0
        if method != C.ROI_ALL:
            _eq(got[2][0], np.zeros(4, np.float32), "empty box")
            assert float(got[1][0].sum()) == 0.0


def test_roi_h_density_falls_back_to_the_largest():
    """A small dense blob under p_min_area_roi of the image loses to the
    largest component; above it, it wins."""
    cam = np.full((32, 32), 0.0, np.float32)
    cam[2:5, 2:5] = 1.0          # 9 px, densest
    cam[10:30, 10:30] = 0.6      # 400 px
    t = torch.from_numpy(cam)[None]
    for p_min, want in ((0.05, 400), (0.005, 9)):
        got = roi.roi_batch(t, C.ROI_H_DENSITY, p_min,
                            torch.tensor([100.0]))[0]
        assert int(got.sum()) == want
        jgot = jroi.roi_one_cam(cam, JC.ROI_H_DENSITY, p_min,
                                thresh=100.0)
        one = roi.roi_one_cam(t[0], C.ROI_H_DENSITY, p_min, thresh=100.0)
        for name, g, w in zip(("roi", "mask", "box"), one, jgot):
            _eq(g, w, name)
        _eq(got[0], jgot[0], "roi")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("thresh", [None, 120.0, 300.0])
def test_roi_one_cam_np_matches_jax(cams, method, thresh):
    jm = {C.ROI_ALL: JC.ROI_ALL, C.ROI_LARGEST: JC.ROI_LARGEST,
          C.ROI_H_DENSITY: JC.ROI_H_DENSITY}[method]
    for cam in list(cams) + [serpentine(32) * 0.9, np.zeros((8, 12),
                                                        np.float32)]:
        got = roi.roi_one_cam_np(cam, method, 0.05, thresh=thresh)
        want = jroi.roi_one_cam_np(cam, jm, 0.05, thresh=thresh)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", METHODS)
def test_roi_batch_agrees_with_the_host_route(cams, method):
    """Tensor route against the scipy route on maps under 64 components
    and 128 steps, at stored thresholds (the two Otsu histograms may
    bin a value an ulp apart)."""
    th = np.full(10, 140.0, np.float32)
    got = roi.roi_batch(torch.from_numpy(cams[:10]), method, 0.05,
                        torch.from_numpy(th))
    for i in range(10):
        want = roi.roi_one_cam_np(cams[i], method, 0.05, thresh=140.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), w)


def test_roi_refuses_an_unknown_method(cams):
    with pytest.raises(ValueError):
        roi.roi_batch(torch.from_numpy(cams[:1]), "roi_nope")
    with pytest.raises(ValueError):
        roi.roi_one_cam_np(cams[0], "roi_nope")


@pytest.mark.parametrize("t", [0.0, 1.0, 30.0, 1e4])
def test_fuse_temporal_max_matches_jax(t):
    rng = np.random.default_rng(3)
    stack = rng.random((5, 3, 7, 7)).astype(np.float32)
    valid = rng.random((5, 3)) > 0.3
    valid[:, 1] = True
    valid[4] = False                 # a row without a valid CAM
    want = np.asarray(jtemporal.fuse_temporal_max(stack, valid, t))
    got = temporal.fuse_temporal_max(torch.from_numpy(stack),
                                     torch.from_numpy(valid), t).numpy()
    np.testing.assert_allclose(got, want, atol=HEAT_ATOL, rtol=0)
    assert (got[4] == 0).all()
    np.testing.assert_allclose(
        temporal.heat_cam(torch.from_numpy(stack), t).numpy(),
        np.asarray(jtemporal.heat_cam(stack, t)), atol=HEAT_ATOL, rtol=0)
