"""Port parity: the data layer (folds, CAM store, dataset, pipeline,
synthetic generator) against the JAX package on the CPU.

One synthetic set from the JAX generator (frames 90 x 120, crop 32,
resize 40, batch 4) with a seeded stand-in CAM store.  The CPU route of
the port's pipeline decodes through its own build of
native/fastloader.cpp, and the JAX pipeline through the JAX package's, so
every batch must be bit-equal.
"""
import filecmp
import os

import numpy as np
import pytest
import torch
import yaml

from tcam_wsol_video_tpu.cams.temporal import DecayTemp as JDecayTemp
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data import native_loader as jnative
from tcam_wsol_video_tpu.data.cam_store import CamStore as JCamStore
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.dataset import heat_cam_np as jheat
from tcam_wsol_video_tpu.data import folds as jfolds
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.pipeline import collate as jcollate
from tcam_wsol_video_tpu.data.pipeline import \
    pad_batch_by_tiling as jpad
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu.data.transforms import \
    normalize_imagenet as jnormalize
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import folds, native_loader
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.dataset import heat_cam_np
from tcam_wsol_video_tpu_torch.data.nvjpeg_loader import \
    resize_crop_normalize
from tcam_wsol_video_tpu_torch.data.pipeline import (DataPipeline, collate,
                                                     pad_batch_by_tiling)
from tcam_wsol_video_tpu_torch.data.synthetic import (
    make_stand_in_cam_store, make_synthetic_dataset)
from tcam_wsol_video_tpu_torch.data.transforms import (PairedTransform,
                                                       normalize_imagenet)

torch.set_num_threads(1)

CROP, RESIZE, BATCH, HW = 32, 40, 4, (90, 120)
# a baseline JPEG at quality 95 with 4:2:0 chroma, decoded, against the
# frame it was encoded from: mean |difference| in levels.  The synthetic
# frames are uniform noise in [0, 60) with a saturated square, so the
# subsampled chroma loses ~10 levels on average (libjpeg: 10.2-10.6 on
# these frames); chip_smoke.py holds nvJPEG's round trip to the same bound
JPEG_MEAN_ABS_TOL = 12.0
KEYS = ("image", "raw_img", "std_cam", "has_cam", "roi", "msk_bbox",
        "fg_size", "label", "valid", "seq_iter", "frm_iter")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    out = jmake(root, frame_hw=HW)
    store = make_stand_in_cam_store(out["metadata_root"],
                                    os.path.join(root, "cams"), seed=3)
    # stored thresholds for the sl_tc_knn = 0 case
    rng = np.random.default_rng(4)
    store.save_thresholds({iid: float(rng.uniform(0.2, 0.6))
                           for iid in folds.load_split_metadata(
                               out["metadata_root"], "val").image_ids})
    return {**out, "cams": os.path.join(root, "cams")}


def _decay(mod, knn, mode, t, min_t, switch):
    return mod(sl_tc_knn_t=t, sl_tc_min_t=min_t, sl_tc_knn=knn,
               sl_tc_knn_mode=mode, sl_tc_knn_epoch_switch_uniform=switch,
               sl_tc_seed_tech=C.SEED_WEIGHTED)


def _pipelines(synth, split, knn, mode, heat):
    """The same dataset and pipeline on both sides."""
    train = split == C.TRAINSET
    jmd = jfolds.load_split_metadata(synth["metadata_root"], split)
    md = folds.load_split_metadata(synth["metadata_root"], split)
    kw = dict(crop_size=CROP, knn_tc=0, sl_tc_knn=knn, sl_tc_knn_mode=mode,
              use_roi=True, roi_method=C.ROI_ALL, p_min_area_roi=0.05)
    dt = ((lambda m: _decay(m, knn, mode, *heat)) if heat
          else (lambda m: None))
    jds = JDataset(jmd, synth["data_root"], split, C.YTOV1,
                   JPT(RESIZE, CROP, train=train), JKeyChain(7),
                   cam_store=JCamStore(synth["cams"]),
                   decay_temp=dt(JDecayTemp), **kw)
    ds = WSOLVideoDataset(md, synth["data_root"], split, C.YTOV1,
                          PairedTransform(RESIZE, CROP, train=train),
                          KeyChain(7), cam_store=CamStore(synth["cams"]),
                          decay_temp=dt(DecayTemp), **kw)
    return (JPipeline(jds, BATCH, JKeyChain(7), shuffle=train),
            DataPipeline(ds, BATCH, KeyChain(7), shuffle=train,
                         device="cpu"))


def _assert_batches_equal(jpipe, pipe, epoch):
    jb = list(jpipe.epoch(epoch))
    pb = list(pipe.epoch(epoch))
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a["image_id"] == b["image_id"]
        for k in KEYS:
            got = b[k].numpy()
            assert got.dtype == a[k].dtype, (k, got.dtype, a[k].dtype)
            np.testing.assert_array_equal(got, a[k], err_msg=k)
    return pb


def test_jax_pipeline_takes_the_native_path():
    assert jnative.available()


# sl_tc_knn 1 before-after with a heat that decays over the epochs, and
# sl_tc_knn 0 with the stored thresholds (no heating)
@pytest.mark.parametrize("knn,mode,heat", [
    (1, C.TIME_BEFORE_AFTER, (2.0, 0.5, 2)),
    (0, C.TIME_INSTANT, None)], ids=["knn1_heated", "stored_thresholds"])
def test_train_batches_bit_equal(synth, knn, mode, heat):
    jpipe, pipe = _pipelines(synth, C.TRAINSET, knn, mode, heat)
    assert pipe.steps_per_epoch() == jpipe.steps_per_epoch() == 3
    for epoch in (0, 1):
        batches = _assert_batches_equal(jpipe, pipe, epoch)
        assert all(b["has_cam"].all() for b in batches)
        assert any(b["roi"].sum() > 0 for b in batches)


def test_val_batches_bit_equal(synth):
    jpipe, pipe = _pipelines(synth, C.VALIDSET, 0, C.TIME_INSTANT, None)
    batches = _assert_batches_equal(jpipe, pipe, 0)
    assert sum(int(b["valid"].sum()) for b in batches) == 24


def test_eval_tail_is_padded_and_invalid(synth):
    """24 val frames at batch 5: the last batch tiles its 4 frames and
    marks the fifth invalid, on both sides."""
    jpipe, pipe = _pipelines(synth, C.VALIDSET, 0, C.TIME_INSTANT, None)
    jpipe.batch_size = pipe.batch_size = 5
    batches = _assert_batches_equal(jpipe, pipe, 0)
    assert batches[-1]["valid"].tolist() == [True] * 4 + [False]
    assert sum(int(b["valid"].sum()) for b in batches) == 24


def test_sharded_epoch_indices_match(synth):
    jpipe, pipe = _pipelines(synth, C.VALIDSET, 0, C.TIME_INSTANT, None)
    for shards in (1, 3, 5):
        for idx in range(shards):
            for p in (jpipe, pipe):
                p.num_shards, p.shard_index = shards, idx
            a, b = jpipe._epoch_indices_valid(0), pipe._epoch_indices_valid(0)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_collate_and_tiling_match():
    rng = np.random.default_rng(0)
    items = [{"image": rng.random((4, 4, 3), np.float32),
              "label": np.int32(i), "raw_img": rng.random((4, 4, 3)),
              "std_cam": rng.random((4, 4)), "has_cam": np.float32(1),
              "seq_iter": np.float32(i), "frm_iter": np.float32(i % 3),
              "roi": rng.integers(0, 2, (4, 4)), "msk_bbox": np.ones((4, 4)),
              "fg_size": np.float32(0.1 * i), "image_id": f"f{i}"}
             for i in range(6)]
    want, got = jcollate(items), collate(items)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for target, clip in ((6, 1), (10, 2), (9, 3)):
        want_p, got_p = jpad(want, target, clip), pad_batch_by_tiling(
            got, target, clip)
        for k in want_p:
            np.testing.assert_array_equal(np.asarray(got_p[k]),
                                          np.asarray(want_p[k]))


def test_heat_and_normalize_match():
    rng = np.random.default_rng(1)
    cam = rng.random((28, 28)).astype(np.float32)
    for t in (0.5, 3.0, 1e4):
        np.testing.assert_array_equal(heat_cam_np(cam, t), jheat(cam, t))
    img = rng.random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(normalize_imagenet(img), jnormalize(img))


def test_folds_match(synth):
    root = synth["metadata_root"]
    for split in ("train", "val", "test"):
        a = jfolds.load_split_metadata(root, split)
        b = folds.load_split_metadata(root, split)
        assert (a.image_ids, a.labels, a.sizes, a.boxes) == \
            (b.image_ids, b.labels, b.sizes, b.boxes)
        if split != "train":
            for iid in a.image_ids[:5]:
                np.testing.assert_array_equal(
                    folds.resized_gt_boxes(b, iid, CROP),
                    jfolds.resized_gt_boxes(a, iid, CROP))
            sa = jfolds.subsample_per_class(a, 2, np.random.default_rng(5))
            sb = folds.subsample_per_class(b, 2, np.random.default_rng(5))
            assert sa.image_ids == sb.image_ids and sa.boxes == sb.boxes
    assert CamStore(synth["cams"]).thresholds == \
        JCamStore(synth["cams"]).thresholds


def test_class_ids_block_and_flow_forms(synth, tmp_path):
    flow = os.path.join(synth["metadata_root"], "class_id.yaml")
    with open(flow) as f:
        assert folds.load_class_ids(synth["metadata_root"]) == \
            yaml.safe_load(f)
    block = tmp_path / "class_id.yaml"
    block.write_text("# classes\naeroplane: 0\n'bird': 1\ncar: 2  # c\n"
                     "\ncat: 3\n")
    assert folds.load_class_ids(str(tmp_path)) == \
        yaml.safe_load(block.read_text())


def test_generator_matches_jax(synth, tmp_path):
    out = make_synthetic_dataset(str(tmp_path), frame_hw=HW, device="cpu",
                                 keep_frames=6)
    cmp = filecmp.dircmp(synth["metadata_root"], out["metadata_root"])
    for split in ("train", "val", "test", "test-video-demo"):
        for name in ("image_ids.txt", "class_labels.txt", "image_sizes.txt",
                     "localization.txt"):
            assert filecmp.cmp(
                os.path.join(synth["metadata_root"], split, name),
                os.path.join(out["metadata_root"], split, name),
                shallow=False), (split, name)
    assert not cmp.left_only and not cmp.right_only
    ids = folds.load_split_metadata(out["metadata_root"], "test").image_ids
    h, w = HW
    ours = native_loader.decode_u8(
        [os.path.join(out["data_root"], i) for i in ids], h, w)
    theirs = native_loader.decode_u8(
        [os.path.join(synth["data_root"], i) for i in ids], h, w)
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2
    for fid, src in out["frames"].items():
        dec = native_loader.decode_u8([os.path.join(out["data_root"], fid)],
                                      h, w)[0]
        assert np.abs(dec.astype(float) - src).mean() <= JPEG_MEAN_ABS_TOL


def test_card_route_resize_matches_fastloader(synth):
    """The card's resize, crop, flip and normalization (run here on the
    CPU from the decoded frames) against fastloader's load_batch."""
    md = folds.load_split_metadata(synth["metadata_root"], "val")
    paths = [os.path.join(synth["data_root"], i) for i in md.image_ids[:6]]
    xs, ys, flips = [0, 3, 8, 1, 5, 2], [8, 0, 2, 7, 4, 1], [0, 1, 0, 1, 1, 0]
    norm, raw = native_loader.load_batch(paths, RESIZE, CROP, np.array(xs),
                                         np.array(ys), np.array(flips))
    frames = torch.from_numpy(native_loader.decode_u8(paths, *HW))
    got_n, got_r = resize_crop_normalize(frames, RESIZE, CROP, xs, ys, flips)
    # the same float32 operations in the same order: bit-equal
    np.testing.assert_array_equal(got_r.numpy(), raw)
    np.testing.assert_array_equal(got_n.numpy(), norm)
