"""The port's span and counter recorder (core/clock.py) on the CPU.

- spans nest: each knows its parent and the step identifier, and its self
  ms is its ms less its children's;
- with no profiler active a span opens no record_function range and makes
  no CUDA event; under torch.profiler each span is a user_annotation range
  of its dotted name in the exported trace, nested as in the program;
- a train epoch on the per-step route (streamed) and on the chunked route
  (the feed, its eager chunks on the CPU) records spans, counts and
  set-up, and every timing key of the epoch record equals what its spans
  give;
- a second Trainer's set-up totals are its own.

A tiny synthetic set (12 shots), crop 24, a one-block ResNet under the
U-Net: a few seconds in all.
"""
import json
import os

import pytest
import torch

from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import clock
from tcam_wsol_video_tpu_torch.core.clock import TRACE, Recorder
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.synthetic import (make_stand_in_cam_store,
                                                      make_synthetic_dataset)
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.models import factory, resnet

torch.set_num_threads(1)

# the epoch record's keys that its readers use (the tests, chip_smoke.py,
# chip_dress_rehearsal.py, the benchmark's metrics, README), the timing
# ones computed from the epoch's spans and counters
RECORD_KEYS = {
    "epoch", "loss", "step_losses", "terms", "classification", "n", "steps",
    "wall_ms", "median_step_ms", "step_ms", "allreduce_ms_per_step", "mesh",
    "data_wait_ms_per_step", "host_enqueue_ms_per_step", "dispatch",
    "dispatch_chunk", "capture_ms", "data_route", "data_pixels_ms_per_step",
    "data_cams_ms_per_step", "data_assembly_ms_per_step", "data_plan_ms",
    "data_fill_ms", "cache_hits", "cache_misses", "pool_misses",
    "pool_decodes", "elb_t", "seed_source", "student_epoch",
    "student_reloads"}


def test_spans_nest_with_parent_self_ms_and_step():
    rec = Recorder()
    rec.step = (3, 1)
    with rec.span("outer") as outer:
        with rec.span("inner.a") as a:
            pass
        rec.step = (3, 2)
        with rec.span("inner.b") as b:
            with rec.span("leaf") as leaf:
                pass
    rec.count("things", 2)
    rec.count("things", 3)
    rec.device("device.gap", [1.5, 2.5])
    assert [s.name for s in rec.spans] == ["outer", "inner.a", "inner.b",
                                           "leaf"]
    assert outer.parent is None and a.parent is outer
    assert b.parent is outer and leaf.parent is b
    assert (outer.step, a.step, b.step, leaf.step) == (
        (3, 1), (3, 1), (3, 2), (3, 2))
    assert outer.self_ms == pytest.approx(outer.ms - a.ms - b.ms, abs=1e-9)
    assert b.self_ms == pytest.approx(b.ms - leaf.ms, abs=1e-9)
    assert leaf.self_ms == leaf.ms >= 0.0
    spans, counts = rec.take()
    assert spans["outer"] == [1, pytest.approx(outer.ms),
                              pytest.approx(outer.self_ms)]
    assert spans["device.gap"] == [2, 4.0, 4.0]
    assert counts == {"things": 5}
    assert rec.take() == ({}, {})


def test_wrap_and_an_open_span_survive_take():
    rec = Recorder()

    @rec.wrap("setup.thing")
    def build(x):
        return x + 1

    with rec.span("epoch"):
        assert build(1) == 2
        spans, _ = rec.take()
        assert set(spans) == {"setup.thing"}
    spans, _ = rec.take()
    assert spans["epoch"][0] == 1


def test_no_profiler_no_range_and_no_cuda_event(monkeypatch):
    made = []

    def spy(kind):
        def ctor(*a, **k):
            made.append(kind)
            raise AssertionError(f"{kind} made by a host span")
        return ctor

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        spy("record_function"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        spy("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", spy("cuda.Event"))
    rec = Recorder()
    with rec.span("epoch"):
        with rec.span("data.wait"):
            rec.count("feed.frames", 4)
    rec.take()
    assert made == []


def test_spans_are_nested_ranges_in_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("epoch"):
            with rec.span("data.wait"):
                with rec.span("data.pixels"):
                    torch.ones(4).sum()
            with rec.span("step.enqueue"):
                torch.zeros(4).add_(1)
    with rec.span("after.profile"):
        pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    by = {e["name"]: e for e in events}
    assert set(by) == {"epoch", "data.wait", "data.pixels", "step.enqueue"}

    def inside(child, parent):
        c, p = by[child], by[parent]
        return (p["ts"] <= c["ts"]
                and c["ts"] + c["dur"] <= p["ts"] + p["dur"])

    assert inside("data.wait", "epoch") and inside("step.enqueue", "epoch")
    assert inside("data.pixels", "data.wait")
    assert not inside("step.enqueue", "data.wait")


def test_importing_the_recorder_imports_nothing_new():
    import subprocess
    import sys
    code = (
        "import sys, functools, time, typing, torch\n"
        "before = set(sys.modules)\n"
        "import tcam_wsol_video_tpu_torch.core.clock\n"
        "print(sorted(set(sys.modules) - before))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.strip() == str(sorted([
        "tcam_wsol_video_tpu_torch", "tcam_wsol_video_tpu_torch.core",
        "tcam_wsol_video_tpu_torch.core.clock"]))


# ------------------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans"))
    out = make_synthetic_dataset(root, frame_hw=(48, 64), device="cpu")
    make_stand_in_cam_store(out["metadata_root"], root + "/cams")
    return root, out["metadata_root"]


def _trainer(synth, outd, *flags):
    """The objects cli/train.main builds (TCAM, exact CRF, fp32), on a
    one-block ResNet."""
    root, meta = synth
    args, _ = parse_args([
        "--task", "TCAM", "--arch", "UnetTCAM", "--data_root", root,
        "--metadata_root", meta, "--std_cams_folder", root + "/cams",
        "--crop_size", "24", "--resize_size", "28", "--batch_size", "4",
        "--eval_batch_size", "8", "--max_epochs", "1",
        "--cam_curve_interval", "0.05", "--freeze_cl", "true",
        "--sl_tc", "true", "--sl_tc_seed_tech", "seed_weighted",
        "--sl_tc_use_roi", "true", "--sl_tc_knn", "1", "--sl_tc_knn_mode",
        "before", "--crf_tc", "true", "--max_sizepos_tc", "true",
        "--compute_dtype", "float32", "--log_every", "0",
        "--checkpoint_save", "0", "--outd", outd, *flags])
    kc = KeyChain(args.seed)
    device = torch.device("cpu")
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, device)
    mp = pytest.MonkeyPatch()
    mp.setattr(factory, "get_encoder",
               lambda name: resnet.ResNetWSOL(layers=(1, 1, 1, 1)))
    try:
        torch.manual_seed(0)
        model = factory.create_model_from_args(args, device=device)
    finally:
        mp.undo()
    return Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                   device=device)


@pytest.fixture(scope="module")
def routes(synth, tmp_path_factory):
    """Two epochs a route: streamed one step a dispatch, and the feed at
    chunk 2 (a chunk of 2 and a tail of 1 a 3-step epoch)."""
    out = {}
    for name, flags in (
            ("stream", ("--train_device_cache_mb", "0")),
            ("chunked", ("--h2d_transfer", "uint8",
                         "--train_device_cache_mb", "64",
                         "--train_dispatch_chunk", "2"))):
        TRACE.take()
        tr = _trainer(synth, str(tmp_path_factory.mktemp(name)), *flags)
        out[name] = (tr, [tr.train_epoch(0), tr.train_epoch(1)])
    return out


def _ms(rec, name):
    return rec["spans"].get(name, [0, 0.0, 0.0])[1]


@pytest.mark.parametrize("route", ["stream", "chunked"])
def test_epoch_records_come_from_the_spans(routes, route):
    _, recs = routes[route]
    for r in recs:
        assert RECORD_KEYS <= set(r)
        assert {"spans", "counts", "setup"} <= set(r)
        steps = r["steps"]
        assert steps == 3
        spans = r["spans"]
        assert spans["epoch"][0] == 1 and spans["epoch.sync"][0] == 1
        assert r["wall_ms"] == spans["epoch"][1]
        assert r["data_wait_ms_per_step"] == pytest.approx(
            _ms(r, "data.wait") / steps)
        assert r["host_enqueue_ms_per_step"] == pytest.approx(
            (_ms(r, "step.enqueue") + _ms(r, "dispatch.replay")) / steps)
        assert r["host_enqueue_ms_per_step"] > 0
        for key, name in (("data_pixels_ms_per_step", "data.pixels"),
                          ("data_cams_ms_per_step", "data.cams"),
                          ("data_assembly_ms_per_step", "feed.assemble")):
            assert r[key] == pytest.approx(_ms(r, name) / steps), key
        assert r["capture_ms"] == _ms(r, "dispatch.capture") == 0.0
        assert r["data_plan_ms"] == _ms(r, "feed.plan")
        assert r["data_fill_ms"] == _ms(r, "feed.fill")
        assert r["pool_misses"] == r["counts"].get("feed.misses", 0)
        assert r["pool_decodes"] == r["counts"].get("feed.decodes", 0)
        assert len(r["step_ms"]) == steps
        # the data wait is its children's time and its own: the pixels
        # and the CAM side streamed, the plan and the pool fill on the feed
        wait = spans["data.wait"]
        parts = (("data.pixels", "data.cams") if route == "stream"
                 else ("feed.plan", "feed.fill"))
        assert wait[1] == pytest.approx(
            sum(_ms(r, p) for p in parts) + wait[2])
        # the epoch's self time is what no child span covers
        children = sum(v[1] for k, v in spans.items()
                       if k in ("data.wait", "step.enqueue", "epoch.sync",
                                "dispatch.replay", "dispatch.release"))
        assert spans["epoch"][2] == pytest.approx(
            spans["epoch"][1] - children, abs=1e-6)
    stream = route == "stream"
    r = recs[0]
    assert r["dispatch"] == ("per_step" if stream else "chunked")
    assert r["data_route"] == ("stream" if stream else "device_feed")
    if stream:
        assert spans_of(r) >= {"data.wait", "data.pixels", "data.cams",
                               "step.enqueue", "device.gap"}
        assert r["spans"]["data.wait"][0] == 4      # 3 batches, then none
        assert r["spans"]["step.enqueue"][0] == 3
        assert r["spans"]["device.gap"][0] == 2     # between 3 steps
        # a CPU device keeps the host CAM side, every frame counted
        assert r["counts"] == {"data.cams_host": r["n"]}
    else:
        assert spans_of(r) >= {"data.wait", "feed.plan", "feed.fill",
                               "dispatch.replay", "feed.assemble",
                               "device.gap"}
        # graphs are freed only at a key change, and the CPU keeps none
        assert "dispatch.release" not in spans_of(r)
        assert r["spans"]["dispatch.replay"][0] == 2
        assert r["spans"]["feed.assemble"][0] == 3
        assert r["spans"]["device.gap"][0] == 1     # between 2 chunks
        frames = r["counts"]["feed.frames"]
        assert 0 < r["counts"]["feed.misses"] <= frames
        assert r["pool_misses"] == r["pool_decodes"]


def spans_of(rec) -> set:
    return set(rec["spans"])


@pytest.mark.parametrize("route", ["stream", "chunked"])
def test_setup_holds_the_build_and_the_first_epoch(routes, route):
    tr, recs = routes[route]
    setup = recs[0]["setup"]
    assert recs[1]["setup"] is setup is tr.setup
    for name in ("setup.data", "setup.model", "setup.trainer"):
        assert setup[name][0] == 1 and setup[name][1] > 0, name
    assert setup["epoch"] == recs[0]["spans"]["epoch"]
    assert not any(k.startswith("setup.") for k in recs[1]["spans"])


def test_setup_totals_clear_when_a_second_trainer_starts(routes, synth,
                                                         tmp_path):
    first = routes["stream"][0].setup
    tr = _trainer(synth, str(tmp_path), "--train_device_cache_mb", "0")
    rec = tr.train_epoch(0)
    assert rec["setup"] is not first
    for name in ("setup.data", "setup.model", "setup.trainer"):
        assert rec["setup"][name][0] == 1, name
    assert rec["setup"]["epoch"] == rec["spans"]["epoch"]
    assert clock.TRACE.spans == [] and clock.TRACE.counts == {}
