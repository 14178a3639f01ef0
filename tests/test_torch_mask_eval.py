"""Port parity of the mask metrics on the CPU: PxAP (MaskEvaluator),
load_gt_mask's PNG reading (data/png.py, without PIL) against the JAX
package's PIL route, the seed diagnostics (metrics/seeds_eval.py) and the
evaluator's OpenImages route (the counterpart of tests/test_e2e.py's
test_openimages_pxap_eval_branch)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tcam_wsol_video_tpu.core.hparams import HParams, finalize, get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data import folds as jfolds
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu.engine import evaluator as jevaluator
from tcam_wsol_video_tpu.metrics import seeds_eval as jseeds
from tcam_wsol_video_tpu.metrics import wsol as jwsol
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import config_for
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import folds, png
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
from tcam_wsol_video_tpu_torch.engine import evaluator
from tcam_wsol_video_tpu_torch.metrics import seeds_eval, wsol
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args

torch.set_num_threads(1)

TAUS = np.arange(0.0, 1.0, 0.01)


@pytest.mark.parametrize("kind", ["random", "empty_masks", "full_masks",
                                  "ties_on_edges"])
def test_pxap_matches(kind):
    rng = np.random.default_rng(1)
    ev, jev = wsol.MaskEvaluator(TAUS), jwsol.MaskEvaluator(TAUS)
    for i in range(6):
        cam = rng.random((24, 20)) ** (1 + i % 3)
        if kind == "ties_on_edges":
            cam = np.round(cam * 20) / 20      # values on the bin edges
        mask = (rng.random((24, 20)) < 0.3).astype(np.float32)
        if kind == "empty_masks":
            mask[:] = 0
        elif kind == "full_masks":
            mask[:] = 1
        ev.accumulate(cam.astype(np.float32), mask)
        jev.accumulate(cam.astype(np.float32), mask)
    np.testing.assert_array_equal(ev.gt_true_hist, jev.gt_true_hist)
    np.testing.assert_array_equal(ev.gt_false_hist, jev.gt_false_hist)
    got, want = ev.compute(), jev.compute()
    assert abs(got - want) <= 1e-12
    assert ev.cnt == 6


def test_pxap_of_nothing_is_zero():
    assert wsol.MaskEvaluator(TAUS).compute() == \
        jwsol.MaskEvaluator(TAUS).compute() == 0.0


def _png_variants(rng, h, w):
    gray = (rng.random((h, w)) < 0.4).astype(np.uint8) * 255
    gray[rng.random((h, w)) < 0.1] = 127
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[gray > 0] = (255, 255, 255)
    pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                       colors=8)
    return {"gray": Image.fromarray(gray, "L"), "rgb": Image.fromarray(rgb),
            "palette": pal,
            "gray1": Image.fromarray(gray > 0).convert("1"),
            "rgba": Image.fromarray(np.dstack([rgb, gray]), "RGBA")}


@pytest.mark.parametrize("size", [7, 32, 224])
def test_load_gt_mask_bit_equal_to_pil(tmp_path, size):
    """Gray, RGB, palette, 1-bit and RGBA masks, at several sizes; an
    image with two masks takes their union."""
    rng = np.random.default_rng(size)
    md = folds.SplitMetadata("test", [], {})
    jmd = jfolds.SplitMetadata("test", [], {})
    for shape in ((30, 41), (64, 48), (250, 300)):
        for name, im in _png_variants(rng, *shape).items():
            rel = f"{name}_{shape[0]}.png"
            im.save(tmp_path / rel)
            iid = f"img_{name}_{shape[0]}"
            md.mask_paths[iid] = jmd.mask_paths[iid] = [rel]
    md.mask_paths["two"] = jmd.mask_paths["two"] = [
        "gray_30.png", "palette_64.png"]
    for iid in md.mask_paths:
        got = folds.load_gt_mask(md, str(tmp_path), iid, size)
        want = jfolds.load_gt_mask(jmd, str(tmp_path), iid, size)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_png_writer_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (17, 23, 3)).astype(np.uint8),
                rng.integers(0, 256, (9, 5)).astype(np.uint8)):
        png.write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "x.png")), img)


def test_seed_accuracy_summary_matches():
    rng = np.random.default_rng(2)
    acc, jacc = seeds_eval.SeedAccuracy(), jseeds.SeedAccuracy()
    for i in range(5):
        seeds = rng.choice([0, 1, -255], size=(16, 16), p=[0.2, 0.1, 0.7])
        if i == 3:
            seeds[seeds == 1] = -255           # an image without fg seeds
        gt = (rng.random((16, 16)) < 0.4).astype(np.float32)
        acc.update(seeds, gt)
        jacc.update(seeds, gt)
    assert acc.summary() == jacc.summary()
    meter, jmeter = seeds_eval.RunningMeter(), jseeds.RunningMeter()
    assert meter.avg == jmeter.avg == 0.0


@pytest.fixture(scope="module")
def openimages(tmp_path_factory):
    """An OpenImages-style split: mask rows in localization.txt, the masks
    beside the images (mask_root empty) or under a tree of their own."""
    root = str(tmp_path_factory.mktemp("oi"))
    data_root = os.path.join(root, "data")
    mask_root = os.path.join(root, "masks")
    meta = os.path.join(root, "folds", "test")
    os.makedirs(meta, exist_ok=True)
    rng = np.random.default_rng(0)
    ids, labels, locs = [], [], []
    for i in range(10):
        sub = f"cls{i % 2}"
        for r in (data_root, mask_root):
            os.makedirs(os.path.join(r, sub), exist_ok=True)
        img = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
        img[10:30, 10 + i:30] = (230, 40, 40)
        iid = f"{sub}/im{i}.jpg"
        Image.fromarray(img).save(os.path.join(data_root, iid))
        mask = np.zeros((48, 48), np.uint8)
        mask[10:30, 10 + i:30] = 255
        if i == 4:
            mask[:] = 0                         # an empty mask
        mpath = f"{sub}/im{i}_mask.png"
        for r in (data_root, mask_root):
            Image.fromarray(mask).save(os.path.join(r, mpath))
        ids.append(iid)
        labels.append(f"{iid},{i % 2}")
        locs.append(f"{iid},{mpath}")
    for name, rows in (("image_ids.txt", ids), ("class_labels.txt", labels),
                       ("localization.txt", locs),
                       ("image_sizes.txt", [f"{i},48,48" for i in ids])):
        with open(os.path.join(meta, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root, data_root, mask_root


def _fake_cam(images, raw=None, targets=None, generator=None):
    cam = (images[..., 0] * 0.125 + 0.5).clamp(0.0, 1.0)
    return cam, images[:, 0, :10, 0]


def _jfake_cam(params, bstats, images, targets, key, raw=None):
    return (jnp.clip(images[..., 0] * 0.125 + 0.5, 0.0, 1.0),
            images[:, 0, :10, 0])


@pytest.mark.parametrize("separate_tree", [False, True])
def test_openimages_pxap_route_matches_jax(openimages, separate_tree):
    root, data_root, mask_root = openimages
    flags = dict(task=C.STD_CL, crop_size=32, resize_size=40,
                 eval_batch_size=8, compute_dtype="float32",
                 cam_curve_interval=0.05,
                 mask_root=mask_root if separate_tree else "")
    args = config_for(C.OpenImages).replace(**flags)
    cfg = get_config(C.OpenImages)
    cfg.update(flags)
    jargs = finalize(HParams(cfg))
    md = folds.load_split_metadata(os.path.join(root, "folds"), "test")
    jmd = jfolds.load_split_metadata(os.path.join(root, "folds"), "test")
    assert md.mask_paths == jmd.mask_paths and md.mask_paths
    ds = WSOLVideoDataset(md, data_root, "test", C.OpenImages,
                          PairedTransform(40, 32, train=False), KeyChain(0),
                          crop_size=32)
    jds = JDataset(jmd, data_root, "test", C.OpenImages,
                   JPT(40, 32, train=False), JKeyChain(0), crop_size=32)
    ev = evaluator.CamEvaluator(
        torch.nn.Identity(), args, ds,
        DataPipeline(ds, 8, KeyChain(0), shuffle=False, device="cpu"),
        "test")
    jev = jevaluator.CamEvaluator(
        None, jargs, jds, JPipeline(jds, 8, JKeyChain(0), shuffle=False),
        "test")
    ev.eval_step, jev.eval_step = _fake_cam, _jfake_cam
    res = ev.run()
    jres = jev.run({"params": {}, "batch_stats": {}},
                   jax.random.PRNGKey(0))
    assert res["n_images"] == jres["n_images"] == 10
    assert abs(res["pxap"] - jres["pxap"]) <= 1e-12
    assert res["localization"] == res["pxap"] > 0
    assert res["classification"] == jres["classification"]
    assert res["timing"]["sweep"] == "pxap"


def test_openimages_route_with_a_model(openimages):
    """The route on a real STD_CL model of the port: a PxAP in range."""
    root, data_root, _ = openimages
    args = config_for(C.OpenImages).replace(
        task=C.STD_CL, crop_size=32, resize_size=40, eval_batch_size=8,
        cam_curve_interval=0.05, eval_transfer="uint16")
    md = folds.load_split_metadata(os.path.join(root, "folds"), "test")
    ds = WSOLVideoDataset(md, data_root, "test", C.OpenImages,
                          PairedTransform(40, 32, train=False), KeyChain(0),
                          crop_size=32)
    torch.manual_seed(0)
    model = create_model_from_args(args, device="cpu")
    res = evaluator.CamEvaluator(
        model, args, ds,
        DataPipeline(ds, 8, KeyChain(0), shuffle=False, device="cpu"),
        "test").run()
    assert 0.0 <= res["pxap"] <= 100.0 and res["n_images"] == 10
