"""Port parity of the demo path on the CPU: FrameReusePlanner against JAX's
on the same sequences; cli.demo_video against JAX's CLI on a tiny
synthetic set (crop 32), the frames compared before encoding
(build_demo_video intercepted on both sides), with reuse off and on; and
the trainer's visual hooks, whose files carry JAX's names and contents.

The CLIs' CAMs are injected on both sides as the same function of the
(bit-equal) batch, so the frames must be equal bit for bit
(CAM_TOLERANCE 0) and the reuse counts equal.
"""
import json
import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tcam_wsol_video_tpu.cli import demo_video as jdemo
from tcam_wsol_video_tpu.core import checkpoint as jckpt
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.engine import trainer as jtrainer
from tcam_wsol_video_tpu.engine.temporal_reuse import \
    FrameReusePlanner as JPlanner
from tcam_wsol_video_tpu_torch.cli import demo_video
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.engine.temporal_reuse import \
    FrameReusePlanner
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args

torch.set_num_threads(1)

# the frames' largest pixel difference (both sides compute the same CAMs)
CAM_TOLERANCE = 0


@pytest.mark.parametrize("threshold", [0.0, 2.0, 9.0])
def test_planner_matches(threshold):
    rng = np.random.default_rng(0)
    planner, jplanner = FrameReusePlanner(threshold), JPlanner(threshold)
    base = {v: rng.uniform(0, 255, (8, 8, 3)) for v in "abc"}
    for step in range(6):
        vids = list(rng.choice(list("abc"), 5))   # in-batch chains
        raws = np.stack([base[v] + rng.normal(0, 1 + 3 * (step % 3),
                                              (8, 8, 3)) for v in vids])
        rows, reuse = planner.plan(vids, raws)
        jrows, jreuse = jplanner.plan(vids, raws)
        assert (rows, reuse) == (jrows, jreuse)
        cams = rng.random((len(vids), 4, 4)).astype(np.float32)
        out = np.zeros((len(vids), 4, 4), np.float32)
        jout = np.zeros_like(out)
        planner.resolve_rows(vids, rows, reuse, cams, out)
        jplanner.resolve_rows(vids, jrows, jreuse, cams, jout)
        np.testing.assert_array_equal(out, jout)
    assert (planner.n_computed, planner.n_reused) == \
        (jplanner.n_computed, jplanner.n_reused)
    assert planner.reuse_fraction == jplanner.reuse_fraction
    if threshold >= 9.0:
        assert planner.n_reused > 0


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    out = jmake(str(root))
    return str(root), out


def _fake_cam(images, raw=None, targets=None, generator=None):
    cam = (images[..., 0] * 0.125 + 0.5).clamp(0.0, 1.0)
    return cam, images[:, 0, :10, 0]


def _jfake_cam(params, bstats, images, targets, key, raw=None):
    return (jnp.clip(images[..., 0] * 0.125 + 0.5, 0.0, 1.0),
            images[:, 0, :10, 0])


def _intercept(monkeypatch, module, store):
    def build(frames, path, fps=8, **kw):
        store[os.path.basename(path)] = [np.array(f) for f in frames]
    monkeypatch.setattr(module.wsol_viz, "build_demo_video", build)


@pytest.mark.parametrize("threshold", ["0", "22"])
def test_demo_cli_frames_match_jax(synth, tmp_path, monkeypatch, threshold):
    root, out = synth
    flags = ["--dataset", C.YTOV1, "--task", C.STD_CL, "--data_root", root,
             "--metadata_root", out["metadata_root"], "--crop_size", "32",
             "--resize_size", "40", "--eval_batch_size", "8",
             "--max_videos", "3", "--reuse_threshold", threshold]
    exp = tmp_path / "exp"
    model = create_model_from_args(
        TCAMConfig(task=C.STD_CL, crop_size=32), device="cpu")
    ckpt.save_best_model(str(exp / C.BEST_LOC), 1, model)
    jckpt.save_best_model(str(exp / C.BEST_LOC), 1, {"params": {}})

    got, want = {}, {}
    _intercept(monkeypatch, demo_video, got)
    _intercept(monkeypatch, jdemo, want)
    monkeypatch.setattr(demo_video, "make_cam_eval_step",
                        lambda m, a: _fake_cam)
    monkeypatch.setattr(jdemo, "make_cam_eval_step", lambda m, a: _jfake_cam)
    planners = []
    real = demo_video.FrameReusePlanner
    monkeypatch.setattr(demo_video, "FrameReusePlanner",
                        lambda t: planners.append(real(t)) or planners[-1])
    jplanners = []
    monkeypatch.setattr("tcam_wsol_video_tpu.engine.temporal_reuse."
                        "FrameReusePlanner",
                        lambda t: jplanners.append(JPlanner(t))
                        or jplanners[-1])
    res = demo_video.main(flags + ["--device", "cpu", "--exp_dir", str(exp),
                                   "--out", str(tmp_path / "p")])
    jwritten = jdemo.main(flags + ["--num_workers", "1", "--exp_dir",
                                   str(exp), "--out", str(tmp_path / "j")])
    assert [os.path.basename(p) for p in res["written"]] == \
        [os.path.basename(p)[:-len(".mp4")] + ".avi" for p in jwritten]
    assert list(got) == [k[:-len(".mp4")] + ".avi" for k in want]
    assert len(got) == 3
    for (name, frames), jframes in zip(got.items(), want.values()):
        assert len(frames) == len(jframes) > 0, name
        for f, jf in zip(frames, jframes):
            assert f.dtype == jf.dtype == np.uint8
            assert np.abs(f.astype(int) - jf).max() <= CAM_TOLERANCE, name
    (p,), (jp,) = planners, jplanners
    assert (p.n_computed, p.n_reused) == (jp.n_computed, jp.n_reused)
    assert (res["computed"], res["reused"]) == (p.n_computed, p.n_reused)
    if threshold != "0":
        assert p.n_reused > 0


def test_trainer_hooks_write_jax_files(synth, tmp_path):
    """The port's trainer with plot_tr_cam_progress and the final visual
    dump: the files JAX's hooks write, under JAX's names; the .pkl, .txt
    and best-tau .yaml equal to what JAX's hooks write from the same
    meters and results."""
    root, out = synth
    res = cli_train.main([
        "--device", "cpu", "--task", C.STD_CL, "--data_root", root,
        "--metadata_root", out["metadata_root"], "--crop_size", "32",
        "--resize_size", "40", "--batch_size", "4", "--eval_batch_size",
        "8", "--max_epochs", "1", "--cam_curve_interval", "0.05",
        "--checkpoint_save", "0", "--outd", str(tmp_path / "exps"),
        "--plot_tr_cam_progress", "true", "--plot_tr_cam_progress_n", "3"])
    outd = res["outd"]
    names = {os.path.relpath(os.path.join(d, f), outd)
             for d, _, fs in os.walk(outd) for f in fs}
    for tag in (C.BEST_LOC, C.BEST_CL):
        assert {f"best_tau_test_{tag}.yaml",
                f"boxacc_test_{tag}.png"} <= names
    assert {"performances.pkl", "performances.txt", "performances.png",
            "performances.json", "progress/epoch_0000.png",
            "visuals/test/ordered_iou_50.yaml"} <= names
    sheets = [n for n in names if n.startswith("visuals/test/50/")
              and n.endswith(".png")]
    # visual_dump_n (JAX's 16) a test pass; both snapshots' passes write
    # to visuals/test, an image ranked alike by both in one file
    assert 16 <= len(sheets) <= 32

    # JAX's hooks on the port's meters and test results
    perf = json.load(open(os.path.join(outd, "performances.json")))
    meters = {}
    for k, m in perf["meters"].items():
        jm = jtrainer.PerformanceMeter()
        jm.history, jm.best_value, jm.best_epoch = (
            m["history"], m["best"], m["best_epoch"])
        meters[k] = jm
    jdir = tmp_path / "jax"
    jdir.mkdir()
    fake = types.SimpleNamespace(
        is_master=True, meters=meters, outd=str(jdir),
        args=types.SimpleNamespace(iou_threshold_list=[30, 50, 70]))
    jtrainer.Trainer.dump_performances(fake)
    tres = res["test"][C.BEST_LOC]
    jtrainer.Trainer.dump_eval_artifacts(fake, "test_best_localization",
                                         tres)
    for name in ("performances.txt", "performances.pkl"):
        assert open(os.path.join(outd, name), "rb").read() == \
            (jdir / name).read_bytes(), name
    with open(os.path.join(outd, "performances.pkl"), "rb") as f:
        assert pickle.load(f)["history"]["train_loss"] == \
            meters["train_loss"].history
    tau = "best_tau_test_best_localization.yaml"
    assert yaml.safe_load(open(os.path.join(outd, tau))) == \
        yaml.safe_load((jdir / tau).read_text())
    assert (jdir / "boxacc_test_best_localization.png").exists()
    # the progress grid: one overlay a fixed frame
    grid = np.asarray(Image.open(os.path.join(outd,
                                              "progress/epoch_0000.png")))
    assert grid.shape == (32, 3 * 32, 3)
