"""Port parity of the stage-1 -> stage-2 handoff: the dump's pixel route
(the whole frame resized as Pillow's BILINEAR does, without Pillow), the
stored ROI threshold rule, and the port's CAM store against the JAX
package's `dump_cams` end to end on a small synthetic set, from the same
stage-1 weights (a small STDClassifier, layers 1,1,1,1, at crop 32).

On this box, libjpeg through native/fastloader.cpp decodes the synthetic
JPEGs to the same bits as Pillow's decoder, so the port's host route and
the JAX dump see the same pixels; the CAMs then differ only by the fp32
forward of the two packages.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_fixtures import (LAYERS, jax_classifier, jax_variables,
                                 torch_classifier)
from tcam_wsol_video_tpu.cli import dump_cams as jdump
from tcam_wsol_video_tpu.core import checkpoint as jckpt
from tcam_wsol_video_tpu.core import constants as C
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu_torch.cli import dump_cams
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core.config import stage1_cam_recipe
from tcam_wsol_video_tpu_torch.data import native_loader
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                                      write_jpeg)
from tcam_wsol_video_tpu_torch.data.transforms import pil_bilinear_resize
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL

torch.set_num_threads(1)

CROP = 32
# the stored CAMs: min-max normalized maps of the two packages' fp32
# forwards (see test_torch_stage1), bilinearly upsampled 4 -> 28; [0, 1]
CAM_ATOL = 1e-4
# a stored threshold may move by one Otsu bin of 1/255 where the
# upsampled CAM sits on a bin edge
THRESH_ATOL = 1.0 / 255.0


@pytest.fixture(scope="module")
def frames_270x360(tmp_path_factory):
    """Synthetic frames at YTOv1's 270 x 360 as JPEGs (libjpeg, quality
    95): noise, a square and a gradient, so every filter tap matters."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:270, 0:360]
    paths = []
    for i in range(4):
        img = (rng.random((270, 360, 3)) * 60 + (xx[..., None] * 0.5)
               ).astype(np.uint8)
        img[40 + 7 * i:150, 60:200 + 9 * i] = (220, 40 + 30 * i, 40)
        path = str(root / f"f{i}.jpg")
        write_jpeg(path, img, device="cpu")
        paths.append(path)
    return paths


def test_libjpeg_decode_is_bit_equal_to_pillow(frames_270x360):
    for path in frames_270x360:
        want = np.asarray(Image.open(path).convert("RGB"))
        hw = native_loader.jpeg_hw(path)
        assert hw == want.shape[:2]
        np.testing.assert_array_equal(native_loader.decode_u8([path], *hw)[0],
                                      want)


@pytest.mark.parametrize("size", [(224, 224), (32, 32), (300, 250)],
                         ids=["to224", "to32", "up300x250"])
def test_resize_bit_equal_to_pillow(frames_270x360, size):
    """Pillow's decode, then its BILINEAR resize against the port's
    integer passes on the same pixels; and the dump's whole host route
    (libjpeg decode + the port's resize) against Pillow's."""
    want = np.stack([
        np.asarray(Image.open(p).convert("RGB").resize(
            (size[1], size[0]), Image.BILINEAR)) for p in frames_270x360])
    decoded = torch.from_numpy(np.stack([
        np.asarray(Image.open(p).convert("RGB")) for p in frames_270x360]))
    got = pil_bilinear_resize(decoded, size)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if size[0] == size[1]:
        route = dump_cams.load_pixels(frames_270x360, size[0],
                                      torch.device("cpu"))
        np.testing.assert_array_equal(route.numpy(), want)


@pytest.mark.parametrize("lo,crop", [(28, 224), (28, 32), (4, 32)])
def test_dump_threshold_matches(lo, crop):
    rng = np.random.default_rng(lo + crop)
    for i in range(6):
        cam = rng.random((lo, lo)).astype(np.float32) ** (1 + i)
        if i == 5:
            cam[:] = 0.25           # a constant map
        assert dump_cams.dump_threshold_np(cam, crop) == \
            jdump.dump_threshold_np(cam, crop)


@pytest.fixture(scope="module")
def dumped(tmp_path_factory, monkeypatch_module):
    """The same small classifier's snapshot in each package's format, and
    each package's dump of a 48-frame synthetic set (2 batches of 32,
    the second padded)."""
    root = str(tmp_path_factory.mktemp("dump"))
    out = make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    jm = jax_classifier()
    variables = jax_variables(jm, seed=11)
    jexp, texp = os.path.join(root, "jexp"), os.path.join(root, "texp")
    jckpt.save_best_model(os.path.join(jexp, C.BEST_LOC), 7, variables)
    ckpt.save_best_model(os.path.join(texp, C.BEST_LOC), 7,
                         torch_classifier(variables))

    monkeypatch_module.setattr(jdump, "create_model_from_args",
                               lambda *a, **k: jm)
    monkeypatch_module.setattr(
        dump_cams, "create_model_from_args",
        lambda *a, **k: STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", 10))
    cfg = get_config(C.YTOV1)
    cfg.update(dict(stage1_cam_recipe(
        crop_size=CROP, data_root=root,
        metadata_root=out["metadata_root"]).__dict__))
    cfg["compute_dtype"] = "float32"
    jdump.dump_cams(HParams(cfg), jexp, os.path.join(root, "jstore"))
    rec = dump_cams.main([
        "--task", "STD_CL", "--data_root", root, "--metadata_root",
        out["metadata_root"], "--crop_size", str(CROP), "--exp_dir", texp,
        "--out", os.path.join(root, "tstore"), "--device", "cpu",
        "--compute_dtype", "float32"])
    return {"jstore": CamStore(os.path.join(root, "jstore")),
            "tstore": CamStore(os.path.join(root, "tstore")), "rec": rec}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_dump_writes_every_train_frame(dumped):
    rec = dumped["rec"]
    assert rec["n_frames"] == 48 and rec["step"] == 7
    th = dumped["tstore"].thresholds
    assert set(th) == set(dumped["jstore"].thresholds)
    assert len(th) == 48
    for fid, t in th.items():
        cam = dumped["tstore"].load_cam(fid)
        assert cam.shape == (28, 28) and cam.dtype == np.float32
        assert 0.0 <= cam.min() and cam.max() <= 1.0 and 0.0 <= t <= 1.0


def test_dumped_cams_match_jax(dumped):
    errs = []
    for fid in dumped["jstore"].thresholds:
        got = dumped["tstore"].load_cam(fid)
        want = dumped["jstore"].load_cam(fid)
        errs.append(np.abs(got.astype(np.float64) - want).max())
    assert max(errs) <= CAM_ATOL, max(errs)


def test_dumped_thresholds_match_jax(dumped):
    want = dumped["jstore"].thresholds
    got = dumped["tstore"].thresholds
    assert max(abs(got[k] - want[k]) for k in want) <= THRESH_ATOL


def test_dump_refuses_a_missing_snapshot(tmp_path):
    args = stage1_cam_recipe(crop_size=CROP)
    with pytest.raises(FileNotFoundError, match="best_localization"):
        dump_cams.load_classifier(args, str(tmp_path), torch.device("cpu"))
