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
  recomputed CAMs keep the per-step loop;
- the values a kept CUDA graph reads from device memory: the optimizer's
  update at 0-d tensor learning rates, ELB and the CAM heat at a tensor
  t, each against its float; the chunked route, which reads them, over 3
  epochs whose learning rate and ELB t change each epoch; and the key
  that decides whether an epoch replays a kept graph or captures anew.
"""
import argparse
import json
import os

import numpy as np
import pytest
import torch

from test_torch_dataplane import (BATCH, SHORT_TAIL, _datasets,  # noqa: F401
                                  synth)
from tcam_wsol_video_tpu.data import pipeline as jpipeline
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu_torch.cams.temporal import fuse_temporal_max
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.engine import scan_train
from tcam_wsol_video_tpu_torch.engine.optim import DecayAllSGD
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.losses.elb import elb, elb_masked_sum_count
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args

torch.set_num_threads(1)

# JAX tests/test_device_feed.py::test_chunked_dispatch_matches_per_step
EPOCH0_RTOL = 1e-3
EPOCH1_RTOL = 5e-2


@pytest.mark.parametrize("knn,knn_tc,batch", [
    pytest.param(0, 0, BATCH, id="0"), pytest.param(1, 0, BATCH, id="1"),
    pytest.param(1, *SHORT_TAIL, id="1-clips_short_tail")])
def test_epoch_plan_matches_jax(synth, knn, knn_tc, batch):  # noqa: F811
    jds, ds = _datasets(synth, knn, C.ROI_LARGEST, knn_tc=knn_tc)
    jpipe = jpipeline.DataPipeline(jds, batch, JKeyChain(7), shuffle=True,
                                   num_workers=1, compact=True,
                                   train_device_cache_mb=64)
    pipe = DataPipeline(ds, batch, KeyChain(7), shuffle=True, compact=True,
                        train_device_cache_mb=64, device="cpu")
    jfeed, feed = jpipe._device_feed, pipe.device_feed
    for epoch in (0, 1):
        jplan, jids, jt = jfeed.epoch_plan(epoch)
        TRACE.take()
        plan, ids, t = feed.epoch_plan(epoch)
        counts = TRACE.take()[1]
        assert ids == jids and t == jt
        assert set(plan) == set(jplan)
        # every sampled frame once, the tiled repeats invalid
        assert plan["valid"].sum() == len(ds) * ds.clip_len
        for k, v in jplan.items():
            np.testing.assert_array_equal(plan[k], np.asarray(v), err_msg=k)
        # the burst made the same frames resident, each decoded once
        np.testing.assert_array_equal(feed.resident,
                                      np.asarray(jfeed.resident))
        assert feed.decodes.max() == 1
        assert counts.get("feed.decodes", 0) == counts["feed.misses"]
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


# ------------------------------------------- values read from device memory
# the optimizer's last add as a product by the rate tensor and an add,
# against torch's fused add: fp32 rounding apart
DEVICE_LR_RTOL = 1e-6


@pytest.mark.parametrize("nesterov", [False, True])
def test_device_learning_rate_matches_the_float_update(nesterov):
    """DecayAllSGD at 0-d tensor learning rates against torch's update at
    the same floats: two groups, weight decay, momentum, a parameter that
    never gets a gradient, the rates changing each step."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(shape, generator=gen)
            for shape in ((5, 3), (4,), (2, 2))]
    grads = [[torch.randn(p.shape, generator=gen) for p in init[:2]]
             for _ in range(3)]
    rates = ((0.1, 0.02), (0.05, 0.01), (0.025, 0.005))

    def run(on_device: bool):
        ps = [torch.nn.Parameter(p.clone()) for p in init]
        opt = DecayAllSGD([{"params": ps[:1]}, {"params": ps[1:]}],
                          lr=0.1, momentum=0.9, weight_decay=1e-4,
                          nesterov=nesterov)
        for step_grads, step_rates in zip(grads, rates):
            for p, g in zip(ps, step_grads):
                p.grad = g.clone()
            for group, lr in zip(opt.param_groups, step_rates):
                group["lr"] = torch.tensor(lr) if on_device else lr
            opt.step()
        return ps, [opt.state[p]["momentum_buffer"] for p in ps]

    (want, want_m), (got, got_m) = run(False), run(True)
    for w, g in zip(want + want_m, got + got_m):
        torch.testing.assert_close(g.detach(), w.detach(),
                                   rtol=DEVICE_LR_RTOL, atol=0.0)
    # the parameter without a gradient was decayed and moved
    assert not torch.equal(got[2].detach(), init[2])


@pytest.mark.parametrize("t", [1.0, 1.01 ** 7, 6.5])
def test_elb_and_heat_at_a_tensor_t_equal_the_float(t):
    gen = torch.Generator().manual_seed(1)
    # both branches: below and above -1/t^2
    fx = torch.randn((64,), generator=gen) * 2.0 - 0.5
    mask = torch.rand((64,), generator=gen) > 0.3
    t_dev = torch.tensor(np.float32(t))
    assert torch.equal(elb(fx, t_dev), elb(fx, t))
    for a, b in zip(elb_masked_sum_count(fx, t_dev, mask),
                    elb_masked_sum_count(fx, t, mask)):
        assert torch.equal(a, b)
    cams = torch.rand((3, 2, 5, 5), generator=gen)
    valid = torch.tensor([[True, True], [True, False], [False, False]])
    assert torch.equal(fuse_temporal_max(cams, valid, t_dev),
                       fuse_temporal_max(cams, valid, t))


def _train_epochs(synth, outd, chunk, epochs, *extra):  # noqa: F811
    """The records of `epochs` train epochs of a Trainer built as
    cli/train.main builds it (no validation between them)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cpu")
    args, _ = parse_args(_flags(synth, outd, chunk, *extra), parser)
    kc = KeyChain(args.seed)
    cpu = torch.device("cpu")
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, cpu)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = create_model_from_args(args, device=cpu)
    tr = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                 device=cpu)
    recs = [tr.train_epoch(e) for e in range(epochs)]
    return recs, {k: v.clone() for k, v in model.state_dict().items()}


# the weights after 9 steps through either route, relative to each
# tensor's largest entry: the same eager steps, the update's rounding
# apart (DEVICE_LR_RTOL; they read equal); a rate or t left at epoch 0's
# moves the epoch losses by 8e-3 and more
ROUTE_WEIGHT_RTOL = DEVICE_LR_RTOL


def test_chunked_route_over_epochs_matches_per_step(
        synth, tmp_path):  # noqa: F811
    """Three epochs whose learning rate halves (a step schedule of step
    size 1) and whose ELB t anneals x 1.5 each epoch: the chunked route
    (its steps read the rate and t from its device scalars) against the
    per-step route (floats), held as test_chunked_route_matches_per_step
    holds an epoch, and the weights at the end."""
    sched = ("--lr", "0.1", "--lr_scheduler", "mystep", "--step_size", "1",
             "--gamma", "0.5", "--elb_mulcoef", "1.5", "--checkpoint_save",
             "0", "--log_every", "0", "--max_epochs", "3")
    per, w_per = _train_epochs(synth, str(tmp_path / "per"), 0, 3, *sched)
    ch, w_ch = _train_epochs(synth, str(tmp_path / "ch"), 2, 3, *sched)
    assert [r["dispatch"] for r in per] == ["per_step"] * 3
    assert [r["dispatch"] for r in ch] == ["chunked"] * 3
    assert len({r["elb_t"] for r in ch}) == 3
    for a, b in zip(per, ch):
        assert a["steps"] == b["steps"] == 3
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=EPOCH0_RTOL)
    assert per[0]["step_losses"][0] == ch[0]["step_losses"][0]
    for k, v in w_per.items():
        if v.is_floating_point():
            assert ((w_ch[k] - v).abs().max()
                    <= ROUTE_WEIGHT_RTOL * v.abs().max()), k


_SHAPES = (("rows", (4,), torch.int64), ("cam_rows", (4, 3), torch.int64))
_PROGRAM = dict(shapes=_SHAPES, switches=[1.0, 1.0, 0.0],
                seed_weighted=True, heat_on=True)


@pytest.mark.parametrize("change,n,kept_after", [
    ({}, 20, 2),
    ({"switches": [1.0, 1.0, 1.0]}, 20, 0),
    ({"seed_weighted": False}, 20, 0),
    ({"heat_on": False}, 20, 0),
    ({"shapes": _SHAPES[:1] + (("cam_rows", (4, 5), torch.int64),)}, 20, 0),
    ({}, 19, 1),
], ids=["same", "switch", "seed_tech", "heat", "plan_shape", "tail_k"])
def test_graph_key_decides_reuse(change, n, kept_after):
    """A 20-step epoch at K = 8 kept a graph of 8 steps and one of 4.  The
    next epoch replays a kept graph whose key it needs, frees every kept
    graph it does not need before it captures, and captures the rest."""
    old = scan_train.program_key(**_PROGRAM)
    assert scan_train.chunk_lengths(20, 8) == [8, 8, 4]
    kept = [(8, old), (4, old)]
    new = scan_train.program_key(**{**_PROGRAM, **change})
    needed = [(k, new) for k in scan_train.chunk_lengths(n, 8)]
    stale = scan_train.stale_graphs(kept, needed)
    left = [key for key in kept if key not in stale]
    assert len(left) == kept_after
    assert all(key in needed for key in left)
    to_capture = {key for key in needed if key not in left}
    assert len(to_capture) == 2 - kept_after
