"""The landmark-CRF cell (tcam_r50_landmarks.feed_nystrom) on the CPU at a
test's size (tests/tiny.py's cell through tests/tiny_nystrom.py): a sound
run is `correct`, each planted fault and the data plane's control are
not; the runner binds the reference's CRF term to the Nystrom filter only
while it runs; the cell's three readers on a canned trace and record; and
kernel 4's bound against a hand count."""
from __future__ import annotations

import pytest

from benchmark.harness import flops, landmark_bound, manifest, report, trace
from benchmark.harness.runners import train, train_nystrom
from benchmark.reference import losses, nystrom
from benchmark.tests import tiny, tiny_nystrom

EXACT_CRF = losses.crf


def _cell(**flags):
    return tiny.cell(tiny_nystrom.CELL, compute_dtype="float32", **flags)


def test_sound_run_is_correct(tmp_path):
    ctx = tiny_nystrom.run(_cell(), str(tmp_path))
    assert ctx["tapped_calls"] >= 3
    assert ctx["correct"], ctx["checks"]
    assert losses.crf is EXACT_CRF


@pytest.mark.parametrize("fault", ("state_unchanged", "half_batch",
                                   "half_loss"))
def test_planted_fault_is_not_correct(fault, tmp_path):
    ctx = tiny_nystrom.run(_cell(), str(tmp_path), fault=fault)
    assert not ctx["correct"], ctx["checks"]


def test_data_control_is_not_correct(tmp_path):
    c = _cell()
    ctx = tiny_nystrom.run(c, str(tmp_path), calibrate=True, alternates=())
    chk = {k: v for k, v in report.checks(
        c, ctx["numbers"]["control_data"]).items() if v["value"] is not None}
    assert chk and not report.is_correct(chk), chk


def test_runner_binds_the_nystrom_term_only_while_it_runs(monkeypatch):
    seen = []

    def fake_run(*a, **k):
        seen.append(losses.crf)
        raise RuntimeError("the program failed")
    monkeypatch.setattr(train, "run", fake_run)
    with pytest.raises(RuntimeError):
        train_nystrom.run(_cell(), 1, 0.0, False, None, 0.0, "")
    assert losses.crf is EXACT_CRF
    assert seen[0].func is nystrom.crf
    assert seen[0].keywords == {"n_landmarks": 1024}


def test_runner_refuses_the_exact_crf():
    c = _cell(crf_impl="exact")
    with pytest.raises(ValueError):
        train_nystrom.run(c, 1, 0.0, False, None, 0.0, "")
    assert losses.crf is EXACT_CRF


def test_knm_bound_is_a_hand_count():
    b, p, m = 32, 224 * 224, 1024
    got = landmark_bound.knm_bound(b, p, m)
    # K_nm and K_mm in fp32 written, then the pixels' and landmarks'
    # five features read
    moved = 4 * 32 * 50176 * 1024 + 4 * 32 * 1024 * 1024 \
        + 4 * 32 * (50176 + 1024) * 5
    assert got["bytes"] == moved == 6_743_654_400
    assert got["bytes_ms"] == pytest.approx(moved / 3.35e12 * 1e3)
    assert got["mufu_ms"] == pytest.approx(
        (32 * 50176 * 1024 + 32 * 1024 * 1024) / flops.MUFU_RATE * 1e3)
    # bytes bound it: 2.01 ms at the recipe's shape
    assert got["bound_ms"] == got["bytes_ms"] == pytest.approx(2.013,
                                                               abs=1e-3)
    assert landmark_bound.knm_bound(b, p, m, knm_bytes=2)["bound_ms"] \
        == pytest.approx(1.031, abs=1e-3)


KNM = "void (anonymous namespace)::build_knm_kernel<5, float>(float const*)"
POTRF = "void potrf_syrk_T16_nc_kernel<float, 5, 4, 4, 5, 4>(int)"
TRSM = "void batch_trsm_left_kernel<float, 64, 4, 3, false, false, false>()"
RHS = ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x32x8_stage3_"
       "warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
OUT = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3_"
       "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"


def _ctx():
    """Two traced steps: kernel 4 10 ms, the solve 3 + 1 ms, the
    products 5 + 5 ms and a convolution 20 ms; two window epochs with
    the span crf.landmarks at their captures."""
    events, ts = [], 0.0
    for name, ms in ((KNM, 10.0), (POTRF, 3.0), (TRSM, 1.0), (RHS, 5.0),
                     (OUT, 5.0), (CONV, 20.0)):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": ms * 1e3})
        ts += ms * 1e3
    t = trace.summarize(events, wall_s=0.1)
    t["steps"] = 2
    recs = [{"steps": 20, "n": 640, "spans": {"crf.landmarks": [9, 30.0,
                                                                 30.0]},
             "counts": {"crf.knm_builds": 40}},
            {"steps": 20, "n": 640, "spans": {"crf.landmarks": [8, 20.0,
                                                                 20.0]},
             "counts": {"crf.knm_builds": 40}}]
    return {"trace": t, "records": recs, "steps": 40, "window_s": 2.0,
            "knm": landmark_bound.knm_bound(32, 224 * 224, 1024)}


def test_knm_build_roofline_reader():
    ctx = _ctx()
    want = 100.0 * ctx["knm"]["bound_ms"] * 2 / 10.0
    assert manifest.reader("knm_build_roofline")(ctx) == pytest.approx(want)


def test_lmk_filter_ms_reader():
    # (10 + 3 + 1 + 5 + 5) ms over 2 steps; the bf16 convolution left out
    assert manifest.reader("lmk_filter_ms.feed")(_ctx()) == pytest.approx(
        12.0)


def test_lmk_span_ms_reader():
    assert manifest.reader("lmk_span_ms.feed")(_ctx()) == pytest.approx(
        25.0)


@pytest.mark.parametrize("name", ["knm_build_roofline", "lmk_filter_ms.feed",
                                  "lmk_span_ms.feed"])
def test_readers_find_nothing_without_the_landmark_route(name):
    """The exact cell's trace and records (no build_knm kernel, no span)
    give None, never 0."""
    ctx = _ctx()
    ctx["trace"]["kernels"] = {CONV: 0.02}
    ctx["records"] = [{"steps": 20, "n": 640, "spans": {}, "counts": {}}]
    ctx.pop("knm")
    assert manifest.reader(name)(ctx) is None
