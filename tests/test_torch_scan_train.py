"""Port parity: chunked training over the card-resident feed
(engine/scan_train.py, train_dispatch_chunk) on the CPU.

- the feed's epoch plan (DeviceTrainFeed.epoch_plan, with its burst pool
  fill) bit-equal to the JAX feed's on the same synthetic set and CAM
  store, for the temporal window off and on;
- the trainer's chunked route against its per-step route through
  cli/train.main (TCAM, feed on, uint8 batches, fp32): the same steps, the
  first step's loss equal and the epoch losses within JAX's own tolerances
  (tests/test_device_feed.py: rtol 1e-3 for epoch 0, 5e-2 for epoch 1; on
  the CPU a chunk is the same eager steps, so they come out equal); chunk
  2 over a 3-step epoch has a tail chunk of 1;
- rolling checkpoints at chunk boundaries;
- the engage rule (JAX's): the feed off, the student seed source or
  recomputed CAMs keep the per-step loop.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_dataplane import BATCH, _datasets, synth  # noqa: F401
from tcam_wsol_video_tpu.data import pipeline as jpipeline
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.engine import scan_train
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer

torch.set_num_threads(1)

# JAX tests/test_device_feed.py::test_chunked_dispatch_matches_per_step
EPOCH0_RTOL = 1e-3
EPOCH1_RTOL = 5e-2


@pytest.mark.parametrize("knn", [0, 1])
def test_epoch_plan_matches_jax(synth, knn):  # noqa: F811
    jds, ds = _datasets(synth, knn, C.ROI_LARGEST)
    jpipe = jpipeline.DataPipeline(jds, BATCH, JKeyChain(7), shuffle=True,
                                   num_workers=1, compact=True,
                                   train_device_cache_mb=64)
    pipe = DataPipeline(ds, BATCH, KeyChain(7), shuffle=True, compact=True,
                        train_device_cache_mb=64, device="cpu")
    jfeed, feed = jpipe._device_feed, pipe._device_feed
    for epoch in (0, 1):
        jplan, jids, jt = jfeed.epoch_plan(epoch)
        plan, ids, t = feed.epoch_plan(epoch)
        assert ids == jids and t == jt
        assert set(plan) == set(jplan)
        for k, v in jplan.items():
            np.testing.assert_array_equal(plan[k], np.asarray(v), err_msg=k)
        # the burst made the same frames resident, each decoded once
        np.testing.assert_array_equal(feed.resident,
                                      np.asarray(jfeed.resident))
        assert feed.decodes.max() == 1
        assert feed.counts["pool_decodes"] == feed.counts["pool_misses"]
    np.testing.assert_array_equal(
        feed.frames_pool.numpy()[feed.resident],
        np.asarray(jfeed.frames_pool)[feed.resident])


def _flags(synth, outd, chunk, *extra):  # noqa: F811
    return ["--device", "cpu", "--task", "TCAM", "--arch", "UnetTCAM",
            "--data_root", synth["root"], "--metadata_root",
            synth["metadata_root"], "--std_cams_folder", synth["cams"],
            "--crop_size", "32", "--resize_size", "40", "--batch_size",
            str(BATCH), "--eval_batch_size", "8", "--max_epochs", "2",
            "--cam_curve_interval", "0.05", "--freeze_cl", "true",
            "--sl_tc", "true", "--sl_tc_seed_tech", "seed_weighted",
            "--sl_tc_use_roi", "true", "--sl_tc_roi_method", "roi_largest",
            "--sl_tc_knn", "1", "--sl_tc_knn_mode", "before", "--crf_tc",
            "true", "--max_sizepos_tc", "true", "--log_every", "1",
            "--compute_dtype", "float32", "--outd", outd,
            "--h2d_transfer", "uint8", "--train_device_cache_mb", "64",
            *(() if chunk is None else ("--train_dispatch_chunk",
                                        str(chunk))), *extra]


def _step_losses(out) -> list:
    with open(os.path.join(out["outd"], "log.json")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["epoch"], r["it"], r["loss"]) for r in recs
            if r.get("split") == "train" and "it" in r]


@pytest.fixture(scope="module")
def routes(synth, tmp_path_factory):  # noqa: F811
    """Two epochs per route: per-step (chunk 0) and chunk 2 (2 + a tail
    of 1 a 3-step epoch), with a rolling checkpoint every 2 steps; the
    steps at which each saved."""
    out = {}
    for chunk in (0, 2):
        saves = []
        orig = Trainer._save_checkpoint

        def spy(self):
            saves.append(self.state.step)
            return orig(self)

        Trainer._save_checkpoint = spy
        try:
            out[chunk] = cli_train.main(_flags(
                synth, str(tmp_path_factory.mktemp(f"c{chunk}")), chunk,
                "--checkpoint_save", "2"))
        finally:
            Trainer._save_checkpoint = orig
        out[chunk]["saves"] = saves
    return out


def test_chunked_route_matches_per_step(routes):
    per, ch = routes[0]["records"]["train"], routes[2]["records"]["train"]
    assert [r["dispatch"] for r in per] == ["per_step"] * 2
    assert [r["dispatch"] for r in ch] == ["chunked"] * 2
    assert [r["dispatch_chunk"] for r in ch] == [2, 2]
    for a, b in zip(per, ch):
        assert a["steps"] == b["steps"] == 3 and a["n"] == b["n"]
        assert b["data_route"] == "device_feed"
        assert len(b["step_ms"]) == 3 and b["host_enqueue_ms_per_step"] > 0
    la, lb = _step_losses(routes[0]), _step_losses(routes[2])
    assert [x[:2] for x in la] == [x[:2] for x in lb]
    assert la[0][2] == lb[0][2]
    np.testing.assert_allclose(ch[0]["loss"], per[0]["loss"],
                               rtol=EPOCH0_RTOL)
    np.testing.assert_allclose(ch[1]["loss"], per[1]["loss"],
                               rtol=EPOCH1_RTOL, atol=EPOCH1_RTOL)
    for tag in routes[0]["test"]:
        assert np.isfinite(routes[2]["test"][tag]["localization"])


def test_checkpoints_land_on_chunk_boundaries(routes):
    # per-step: every 2nd step and each epoch's end; chunked: the end of
    # a chunk that crosses a multiple of 2, and each epoch's end
    assert routes[0]["saves"] == [2, 3, 4, 6, 6]
    assert routes[2]["saves"] == [2, 3, 5, 6, 6]


def test_engage_rule():
    args = TCAMConfig(task=C.TCAM, arch=C.UNETTCAM)
    feed = object()
    assert scan_train.engages(args, feed, False, False)
    assert not scan_train.engages(args, None, False, False)
    assert not scan_train.engages(args, feed, True, False)
    assert not scan_train.engages(args, feed, False, True)
    assert not scan_train.engages(args.replace(train_dispatch_chunk=0),
                                  feed, False, False)


def test_student_switch_and_feed_off_keep_the_per_step_loop(
        synth, tmp_path):  # noqa: F811
    # no --train_dispatch_chunk: JAX's default 8 engages with the feed
    out = cli_train.main(_flags(synth, str(tmp_path / "sw"), None,
                                "--sl_tc_epoch_switch_to_sl", "1",
                                "--checkpoint_save", "0"))
    train = out["records"]["train"]
    assert [r["seed_source"] for r in train] == ["batch", "student"]
    assert [r["dispatch"] for r in train] == ["chunked", "per_step"]
    assert train[0]["dispatch_chunk"] == 8
    out = cli_train.main(_flags(synth, str(tmp_path / "off"), None,
                                "--train_device_cache_mb", "0",
                                "--max_epochs", "1",
                                "--checkpoint_save", "0"))
    assert [(r["data_route"], r["dispatch"]) for r in
            out["records"]["train"]] == [("stream", "per_step")]
