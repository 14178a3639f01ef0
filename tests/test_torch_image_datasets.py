"""Port parity of the image datasets on the CPU: CUB, ILSVRC and
OpenImages' defaults and refusals against JAX's get_config / finalize;
bit-equal batches on a frames layout made from the synthetic set; ILSVRC's
buckets (the counterpart of tests/test_buckets.py: the subsets, the
stager's commands, the trainer's loop seeing every train id once an
epoch); and the builders' folds and cli.build_dataset byte for byte
against JAX's on the raw releases that tests/test_builders.py makes."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_builders import _jpg, _make_raw_release, _ytbb_csv
from tcam_wsol_video_tpu.cli import build_dataset as jbuild_cli
from tcam_wsol_video_tpu.core.hparams import HParams, finalize as jfinalize
from tcam_wsol_video_tpu.core.hparams import get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data import builders as jbuilders
from tcam_wsol_video_tpu.data import folds as jfolds
from tcam_wsol_video_tpu.data import ilsvrc_buckets as jbuckets
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu_torch.cli import build_dataset as build_cli
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import (config_for, finalize,
                                                   parse_args)
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import builders, folds, ilsvrc_buckets
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform

torch.set_num_threads(1)

IMAGE_SETS = (C.CUB, C.ILSVRC, C.OpenImages)


@pytest.mark.parametrize("ds", IMAGE_SETS)
def test_defaults_match_get_config(ds):
    ref = get_config(ds)
    got = config_for(ds).__dict__
    assert set(got) == set(ref)
    assert {k: v for k, v in got.items() if ref[k] != v} == {}
    parsed, _ = parse_args(["--dataset", ds])
    jargs = jfinalize(HParams(get_config(ds)))
    assert parsed.nbr_buckets == jargs.nbr_buckets
    assert parsed.num_classes == C.NUMBER_CLASSES[ds]


@pytest.mark.parametrize("ds", IMAGE_SETS)
def test_refusals_match_jax(ds):
    cases = [dict(eval_transfer="uint8"),
             dict(task=C.TCAM, arch=C.UNETTCAM)]
    for bad in cases:
        cfg = get_config(ds)
        cfg.update(bad)
        refused = False
        try:
            jfinalize(HParams(cfg))
        except AssertionError:
            refused = True
        if refused:
            with pytest.raises(ValueError):
                finalize(config_for(ds).replace(**bad))
        else:
            assert finalize(config_for(ds).replace(**bad))
    # uint8 is refused on OpenImages alone; TCAM on every image set
    with pytest.raises(ValueError):
        finalize(config_for(C.OpenImages).replace(eval_transfer="uint8"))
    assert finalize(config_for(C.CUB).replace(eval_transfer="uint8"))


@pytest.fixture(scope="module")
def frames_layout(tmp_path_factory):
    """The synthetic set's frames as an image set: every train shot's
    frames become train ids; val and test keep their frames and boxes."""
    root = str(tmp_path_factory.mktemp("frames"))
    out = jmake(root)
    meta = os.path.join(root, "folds_frames")
    for split in ("train", "val", "test"):
        md = jfolds.load_split_metadata(out["metadata_root"], split)
        d = os.path.join(meta, split)
        os.makedirs(d)
        ids = []
        for iid in md.image_ids:
            full = os.path.join(out["data_root"], iid)
            if os.path.isdir(full):
                ids += [f"{iid}/{f}" for f in sorted(os.listdir(full))
                        if f.endswith(".jpg")]
            else:
                ids.append(iid)
        labels = {i: md.labels["/".join(i.split("/")[:5])]
                  if i not in md.labels else md.labels[i] for i in ids}
        with open(os.path.join(d, "image_ids.txt"), "w") as f:
            f.writelines(f"{i}\n" for i in ids)
        with open(os.path.join(d, "class_labels.txt"), "w") as f:
            f.writelines(f"{i},{labels[i]}\n" for i in ids)
        with open(os.path.join(d, "image_sizes.txt"), "w") as f:
            f.writelines(f"{i},{w},{h}\n" for i, (w, h) in md.sizes.items())
        with open(os.path.join(d, "localization.txt"), "w") as f:
            for i, boxes in md.boxes.items():
                for b in boxes:
                    f.write(f"{i},{b[0]},{b[1]},{b[2]},{b[3]}\n")
    return out["data_root"], meta


@pytest.mark.parametrize("split", ["train", "val"])
def test_frames_layout_batches_bit_equal(frames_layout, split):
    data_root, meta = frames_layout
    train = split == "train"
    md = folds.load_split_metadata(meta, split)
    jmd = jfolds.load_split_metadata(meta, split)
    ds = WSOLVideoDataset(md, data_root, split, C.CUB,
                          PairedTransform(40, 32, train=train), KeyChain(3),
                          crop_size=32)
    jds = JDataset(jmd, data_root, split, C.CUB, JPT(40, 32, train=train),
                   JKeyChain(3), crop_size=32)
    assert ds.mode == jds.mode == C.DS_FRAMES
    pipe = DataPipeline(ds, 8, KeyChain(3), shuffle=train, device="cpu")
    jpipe = JPipeline(jds, 8, JKeyChain(3), shuffle=train)
    for epoch in (0, 1) if train else (0,):
        got, want = list(pipe.epoch(epoch)), list(jpipe.epoch(epoch))
        assert len(got) == len(want) > 0
        for b, a in zip(got, want):
            assert b["image_id"] == a["image_id"]
            for k in ("image", "raw_img", "label", "valid"):
                np.testing.assert_array_equal(b[k].numpy(), a[k], k)
    for iid in md.image_ids[:5] if not train else ():
        np.testing.assert_array_equal(ds.eval_gt_boxes(iid),
                                      jds.eval_gt_boxes(iid))


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """The synthetic set with its train split in 3 chunk files."""
    root = str(tmp_path_factory.mktemp("buckets"))
    out = jmake(root)
    md = jfolds.load_split_metadata(out["metadata_root"], "train")
    ids = list(md.image_ids)
    tr_dir = os.path.join(out["metadata_root"], "train")
    for i, chunk in enumerate((ids[:5], ids[5:9], ids[9:])):
        with open(os.path.join(tr_dir, f"train_chunk_{i}.txt"), "w") as f:
            f.write("\n".join(chunk) + "\n")
    return root, out


def test_bucket_subsets_and_commands_match(chunked):
    _, out = chunked
    meta = out["metadata_root"]
    for n_chunks, sz in ((3, 1), (3, 2), (240, 8), (7, 3)):
        assert ilsvrc_buckets.num_buckets(n_chunks, sz) == \
            jbuckets.num_buckets(n_chunks, sz)
        assert ilsvrc_buckets.chunk_list(list(range(n_chunks)), sz) == \
            jbuckets.chunk_list(list(range(n_chunks)), sz)
    for sz in (1, 2):
        for b in range(ilsvrc_buckets.num_buckets(3, sz)):
            assert ilsvrc_buckets.bucket_image_ids(meta, b, 3, sz) == \
                jbuckets.bucket_image_ids(meta, b, 3, sz)
    with pytest.raises(ValueError):
        ilsvrc_buckets.bucket_image_ids(meta, 3, 3, 1)
    stager = ilsvrc_buckets.shell_stager("cp -r a/{bucket} b", "rm -r b")
    # JAX's CLI: ["bash", "-c", template with {bucket} substituted]
    assert stager.stage_cmd(2) == ["bash", "-c", "cp -r a/2 b"]
    assert stager.cleanup_cmd(2) == ["bash", "-c", "rm -r b"]
    assert ilsvrc_buckets.shell_stager("", "").stage_cmd is None
    events = []
    stager.prepare = lambda b: events.append(("prep", b))
    stager.cleanup = lambda b: events.append(("clean", b))
    assert list(stager(range(2))) == [0, 1]
    assert events == [("prep", 0), ("clean", 0), ("prep", 1), ("clean", 1)]


@pytest.mark.parametrize("chunk", ["0", "8"])
def test_bucket_loop_sees_every_train_id_once(chunked, tmp_path, chunk):
    """cli.train on 2 buckets (chunks {0, 1} and {2}) with the stage and
    cleanup commands: each bucket staged and cleaned, the epoch's frames
    one per train shot, per-step and chunked (the card-resident feed's
    route on the CPU)."""
    root, out = chunked
    mark = tmp_path / "marks"
    mark.mkdir()
    seen = []
    real = DataPipeline.epoch

    def spy(self, epoch, subset=None):
        if self.ds.split == "train":
            seen.append(None if subset is None else sorted(subset.tolist()))
        return real(self, epoch, subset)

    mp = pytest.MonkeyPatch()
    mp.setattr(DataPipeline, "epoch", spy)
    try:
        res = cli_train.main([
            "--device", "cpu", "--task", C.STD_CL, "--data_root", root,
            "--metadata_root", out["metadata_root"], "--crop_size", "32",
            "--resize_size", "40", "--batch_size", "4", "--eval_batch_size",
            "8", "--max_epochs", "1", "--cam_curve_interval", "0.2",
            "--checkpoint_save", "0", "--outd", str(tmp_path / "exps"),
            "--ds_chunkable", "true", "--nbr_chunks", "3", "--bucket_sz",
            "2", "--train_device_cache_mb", "64", "--train_dispatch_chunk",
            chunk, "--bucket_stage_cmd", f"touch {mark}/staged_{{bucket}}",
            "--bucket_cleanup_cmd", f"touch {mark}/cleaned_{{bucket}}"])
    finally:
        mp.undo()
    for b in (0, 1):
        assert (mark / f"staged_{b}").is_file()
        assert (mark / f"cleaned_{b}").is_file()
    n_train = len(folds.load_split_metadata(out["metadata_root"],
                                            "train").image_ids)
    (rec,) = res["records"]["train"]
    assert rec["n"] == n_train
    assert rec["dispatch"] == ("chunked" if chunk == "8" else "per_step")
    if chunk == "0":
        assert seen == [list(range(9)), list(range(9, n_train))]


def _tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_jpeg_size_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(((32, 24), (1, 1), (640, 17), (300, 301))):
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
        for kw in ({}, {"progressive": True}, {"quality": 20}):
            p = str(tmp_path / f"{i}_{len(kw)}.jpg")
            img.save(p, **kw)
            assert builders.jpeg_size(p) == Image.open(p).size


@pytest.mark.parametrize("version", ["v1.0", "v2.2"])
def test_yto_builder_byte_equal(tmp_path, version):
    raw = str(tmp_path / "raw")
    _make_raw_release(raw, n_classes=3, n_videos=7, n_frames=3)
    _jpg(os.path.join(raw, "class0", "data", "vid0", "shots", "002",
                      "frame_9.jpg"), w=50, h=30)
    want = jbuilders.build_metadata(raw, str(tmp_path / "j"), version)
    got = builders.build_metadata(raw, str(tmp_path / "p"), version)
    assert got == want
    assert _tree_bytes(tmp_path / "p") == _tree_bytes(tmp_path / "j")
    build_cli.main(["yto", "--raw_root", raw, "--out",
                    str(tmp_path / "pc"), "--version", version])
    jbuild_cli.main(["yto", "--raw_root", raw, "--out",
                     str(tmp_path / "jc"), "--version", version])
    assert _tree_bytes(tmp_path / "pc") == _tree_bytes(tmp_path / "jc") == \
        _tree_bytes(tmp_path / "j")


def test_ytbb_builder_byte_equal(tmp_path):
    frames = str(tmp_path / "frames")
    rows = []
    for yid, cls, n in (("vidA", "cat", 3), ("vidB", "cat", 2),
                        ("vidC", "dog", 2), ("vidD", "dog", 2)):
        for t in range(n):
            rows.append((yid, 1000 * t, 0, cls, 0, "present", 0.25, 0.75,
                         0.2, 0.9))
            _jpg(os.path.join(frames, cls, f"{yid}_0", "0",
                              f"{1000 * t}.jpg"), w=40, h=20)
    rows.append(("vidM", 0, 0, "cat", 0, "present", 0, 1, 0, 1))
    rows.append(("vidM", 0, 1, "dog", 1, "present", 0, 1, 0, 1))
    _jpg(os.path.join(frames, "cat", "vidM_0", "0", "0.jpg"))
    _ytbb_csv(tmp_path / "tr.csv", rows)
    _ytbb_csv(tmp_path / "va.csv",
              [("vidT", 0, 0, "cat", 0, "present", 0.0, 0.5, 0.0, 0.5)])
    _jpg(os.path.join(frames, "cat", "vidT_0", "0", "0.jpg"), w=33, h=21)
    args = ["ytbb", "--csv_train", str(tmp_path / "tr.csv"),
            "--csv_validation", str(tmp_path / "va.csv"), "--frames_root",
            frames, "--k_val", "1"]
    build_cli.main(args + ["--out", str(tmp_path / "p")])
    jbuild_cli.main(args + ["--out", str(tmp_path / "j")])
    assert _tree_bytes(tmp_path / "p") == _tree_bytes(tmp_path / "j")
    assert _tree_bytes(tmp_path / "p")
