"""The readers of the program's spans and counters (metrics/_spans.py and
the metrics that use it) on canned trainer records: each on records with
its keys, and None on records of a program without the recorder."""
from __future__ import annotations

import pytest

from benchmark.harness import manifest

SPAN_METRICS = ("setup_build_s", "setup_warmup_s", "step_gap_ms.feed",
                "step_gap_ms.stream", "epoch_edge_ms.feed",
                "data_pixels_ms.stream", "data_self_ms.stream",
                "pool_hit_ratio.feed")

SETUP = {"setup.data": [1, 900.0, 900.0], "setup.model": [2, 1500.0, 1500.0],
         "setup.trainer": [1, 100.0, 80.0], "setup.kernels": [1, 500.0, 500.0],
         "epoch": [1, 6000.0, 40.0]}


def _records():
    common = {"steps": 4, "n": 128, "setup": SETUP}
    return [
        {**common,
         "spans": {"epoch": [1, 2000.0, 30.0],
                   "data.wait": [5, 400.0, 40.0],
                   "data.pixels": [4, 200.0, 200.0],
                   "data.cams": [4, 160.0, 160.0],
                   "device.gap": [3, 360.0, 360.0]},
         "counts": {"feed.frames": 100, "feed.misses": 20}},
        {**common,
         "spans": {"epoch": [1, 1800.0, 10.0],
                   "data.wait": [5, 440.0, 80.0],
                   "data.pixels": [4, 240.0, 240.0],
                   "data.cams": [4, 120.0, 120.0],
                   "device.gap": [3, 440.0, 440.0]},
         "counts": {"feed.frames": 100, "feed.misses": 0}},
    ]


def _ctx(records):
    return {"records": records, "window_s": 2.0, "frames": 256, "steps": 8,
            "setup_s": 31.5}


@pytest.mark.parametrize("name,want", [
    ("setup_build_s", 3.0), ("setup_warmup_s", 6.0),
    ("step_gap_ms.feed", 100.0), ("step_gap_ms.stream", 100.0),
    ("epoch_edge_ms.feed", 20.0), ("data_pixels_ms.stream", 55.0),
    ("data_self_ms.stream", 15.0), ("pool_hit_ratio.feed", 90.0)])
def test_span_reader(name, want):
    assert manifest.reader(name)(_ctx(_records())) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_reader_without_the_recorder_is_none(name):
    """The parent's records: the timing keys, no spans, counts or set-up."""
    old = [{"steps": 4, "n": 128, "data_wait_ms_per_step": 10.0,
            "step_ms": [50.0] * 4}]
    assert manifest.reader(name)(_ctx(old)) is None


def test_data_wait_is_its_parts():
    """data_pixels_ms + data_cams_ms + data_self_ms = data_wait_ms, per
    step, by construction."""
    ctx = _ctx(_records())
    wait = sum(r["spans"]["data.wait"][1] for r in ctx["records"]) / 8
    cams = sum(r["spans"]["data.cams"][1] for r in ctx["records"]) / 8
    parts = (manifest.reader("data_pixels_ms.stream")(ctx) + cams
             + manifest.reader("data_self_ms.stream")(ctx))
    assert parts == pytest.approx(wait)


def test_a_span_missing_from_some_epochs_reads_zero_there():
    recs = _records()
    del recs[1]["spans"]["device.gap"]
    assert manifest.reader("step_gap_ms.stream")(_ctx(recs)) == \
        pytest.approx(360.0 / 8)


def test_the_new_metrics_are_in_the_manifest():
    bench = manifest.load()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(SPAN_METRICS):] == list(SPAN_METRICS)
    for m in bench["per_layer"][-len(SPAN_METRICS):]:
        assert m["workloads"]
