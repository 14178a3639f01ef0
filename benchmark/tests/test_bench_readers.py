"""The metric readers on canned trainer records and a canned trace, and
the trace's reduction."""
from __future__ import annotations

import pytest

from benchmark.harness import flops, manifest, trace


def _records():
    common = {"steps": 4, "n": 128}
    return [
        {**common, "data_wait_ms_per_step": 10.0,
         "data_cams_ms_per_step": 2.0, "host_enqueue_ms_per_step": 30.0,
         "capture_ms": 300.0, "dispatch": "chunked",
         "step_ms": [50.0, 50.0, 60.0, 60.0]},
        {**common, "data_wait_ms_per_step": 20.0,
         "data_cams_ms_per_step": 4.0, "host_enqueue_ms_per_step": 34.0,
         "capture_ms": 100.0, "dispatch": "chunked",
         "step_ms": [52.0, 52.0, 52.0, 52.0]},
    ]


def _ctx():
    t = trace.summarize([
        {"ph": "X", "cat": "kernel", "name": "bilateral_pairs_kernel",
         "ts": 0.0, "dur": 400_000.0},
        {"ph": "X", "cat": "kernel", "name": "bilateral_reduce_kernel",
         "ts": 400_000.0, "dur": 100_000.0},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 700_000.0,
         "dur": 100_000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
         "ts": 550_000.0, "dur": 100_000.0},
    ], wall_s=1.0)
    t["steps"] = 2
    return {"records": _records(), "window_s": 2.0, "frames": 256,
            "steps": 8, "setup_s": 31.5, "trace": t,
            "model_flops_per_step": 2.0e12,
            "crf": flops.filter_bound(32, 224 * 224)}


def test_trace_summary():
    t = _ctx()["trace"]
    assert t["busy_s"] == pytest.approx(0.6)
    assert t["breakdown"]["idle_gaps"] == [["aten::copy_",
                                            pytest.approx(0.2)]]
    assert t["breakdown"]["device_ops"][0] == ["bilateral_pairs_kernel",
                                               pytest.approx(0.4)]
    assert trace.kernel_seconds(t, "bilateral") == pytest.approx(0.5)


@pytest.mark.parametrize("name,want", [
    ("setup_s", 31.5), ("train_frames_per_s", 128.0),
    ("stream_frames_per_s", 128.0), ("data_wait_ms.feed", 15.0),
    ("data_wait_ms.stream", 15.0), ("data_cams_ms.stream", 3.0),
    ("host_enqueue_ms.feed", 32.0), ("capture_ms.feed", 200.0),
    ("step_ms.feed", 52.0), ("step_ms.stream", 52.0),
    ("device_idle.feed", 40.0), ("device_idle.stream", 40.0)])
def test_reader(name, want):
    assert manifest.reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["step_mfu.feed", "step_mfu.stream"])
def test_mfu_reader(name):
    ctx = _ctx()
    per_step = 2.0e12 + ctx["crf"]["ops"]
    want = 100.0 * per_step * 8 / 2.0 / flops.BF16_TENSOR_FLOPS
    assert manifest.reader(name)(ctx) == pytest.approx(want)


def test_roofline_reader():
    ctx = _ctx()
    want = 100.0 * ctx["crf"]["bound_ms"] * 1e-3 * 2 / 0.5
    assert manifest.reader("crf_filter_roofline")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in manifest.load()[
    "per_layer"]])
def test_reader_finds_nothing_to_read(name):
    """A reader that finds nothing returns None, never 0."""
    assert manifest.reader(name)({"records": [], "steps": 0,
                                  "window_s": 1.0}) is None


def test_filter_bound_is_chip_smokes():
    b = flops.filter_bound(32, 224 * 224)
    assert b["pairs"] == 32 * 50176 * 50177 // 2
    # operation-bound at the recipe's shape: 12.0 ms (PERF.md, kernel 1)
    assert b["bound_ms"] == pytest.approx(12.02, abs=0.01)
    assert b["bound_ms"] == max(b["mufu_ms"], b["fp32_ms"], b["bytes_ms"])
