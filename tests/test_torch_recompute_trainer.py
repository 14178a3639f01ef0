"""TCAM without a CAM store through the port's trainer and CLI, on the CPU
(the counterpart of tests/test_tcam_e2e.py's
test_tcam_without_cam_store_recomputes_seeds).

The trainer takes the recompute branch exactly when the train set has no
store and a classifier is given; the seeder then sees the classifier's
non-zero CAMs, not the dataset's zeros.  Through cli/train.py, stage 2
without --std_cams_folder reads its seeder from the stage-1 folder's
tcam_pretrained_seeder_ch_pt snapshot, and building that classifier
leaves the stage-2 model's random draw alone.
"""
import os

import numpy as np
import pytest
import torch

import tcam_wsol_video_tpu_torch.engine.steps as tsteps_mod
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.synthetic import (make_stand_in_cam_store,
                                                      make_synthetic_dataset)
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recompute"))
    out = make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    make_stand_in_cam_store(out["metadata_root"], os.path.join(root, "cams"))
    return root


def _common(root):
    return ["--dataset", "YouTube-Objects-v1.0", "--data_root", root,
            "--metadata_root", os.path.join(root, "folds"),
            "--crop_size", "32", "--resize_size", "40",
            "--cam_curve_interval", "0.05", "--eval_batch_size", "8",
            "--log_every", "0", "--checkpoint_save", "0"]


def _stage2(root, outd, *extra):
    return _common(root) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--batch_size", "4",
        "--max_epochs", "1", "--lr", "0.01", "--freeze_cl", "true",
        "--sl_tc", "true", "--sl_tc_min", "1", "--sl_tc_max", "1",
        "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6", "--sl_tc_min_p", "0.1",
        "--sl_tc_seed_tech", "seed_weighted", "--sl_tc_use_roi", "false",
        "--crf_tc", "true", "--max_sizepos_tc", "true",
        "--max_sizepos_tc_lambda", "0.01", "--seed", "1",
        "--outd", outd, "--exp_id", "s2", *extra]


def _small_trainer(root, outd, store: bool):
    args, _ = parse_args(_stage2(root, outd) + (
        ["--std_cams_folder", os.path.join(root, "cams")] if store else []))
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, "cpu")
    torch.manual_seed(0)
    model = UnetTCAM(ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10,
                     freeze_cl=True)
    cls = STDClassifier(ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10)
    cls = cls.eval().requires_grad_(False)
    return Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                   device="cpu", classifier=cls)


@pytest.fixture
def seeder_inputs(monkeypatch):
    """The CAMs each step hands the seeder."""
    seen = []
    orig = tsteps_mod.tcam_seeder

    def spy(cams, cfg, **kw):
        seen.append(cams.detach().clone())
        return orig(cams, cfg, **kw)

    monkeypatch.setattr(tsteps_mod, "tcam_seeder", spy)
    return seen


def test_trainer_recomputes_without_a_store(synth, tmp_path, seeder_inputs):
    tr = _small_trainer(synth, str(tmp_path), store=False)
    assert tr.train_pipe.ds.cam_store is None
    assert tr._recompute_cams
    m = tr.train_epoch(0)
    assert np.isfinite(m["loss"]) and m["steps"] == len(seeder_inputs) == 3
    for cams in seeder_inputs:
        assert cams.shape == (4, 32, 32)
        assert cams.min() >= 0.0 and cams.max() <= 1.0
        assert all(float(c.max()) > 0.0 for c in cams)


def test_trainer_with_a_store_reads_it(synth, tmp_path, seeder_inputs):
    tr = _small_trainer(synth, str(tmp_path), store=True)
    assert isinstance(tr.train_pipe.ds.cam_store, CamStore)
    assert not tr._recompute_cams
    tr.train_epoch(0)
    # the stand-in store's CAMs, as the dataset fused them
    assert len(seeder_inputs) == 3


def test_seeder_classifier_leaves_the_random_draw(synth):
    args, _ = parse_args(_stage2(synth, "unused"))
    torch.manual_seed(3)
    want = torch.rand(4)
    torch.manual_seed(3)
    cls, step = cli_train.load_seeder_classifier(args, KeyChain(1), "cpu")
    assert torch.equal(torch.rand(4), want)
    assert step is None and not cls.training
    assert not any(p.requires_grad for p in cls.parameters())
    # the same key chain draws the same classifier
    again, _ = cli_train.load_seeder_classifier(args, KeyChain(1), "cpu")
    for a, b in zip(cls.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def cli_run(synth, tmp_path_factory):
    """Stage 1 for 1 epoch, then stage 2 through the CLI from its folder
    without a CAM store, with the seeder classifier and its CAMs
    recorded."""
    outd = str(tmp_path_factory.mktemp("exps"))
    cpu = ["--device", "cpu"]
    s1 = cli_train.main(_common(synth) + [
        "--task", "STD_CL", "--batch_size", "4", "--max_epochs", "1",
        "--lr", "0.01", "--outd", outd, "--exp_id", "s1"] + cpu)
    got = {"cams": []}
    load = cli_train.load_seeder_classifier
    seeder = tsteps_mod.tcam_seeder

    def load_spy(args, kc, device):
        model, step = load(args, kc, device)
        got["classifier"] = {k: v.clone() for k, v in
                             model.state_dict().items()}
        return model, step

    def seeder_spy(cams, cfg, **kw):
        got["cams"].append(cams.detach().clone())
        return seeder(cams, cfg, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train, "load_seeder_classifier", load_spy)
        mp.setattr(tsteps_mod, "tcam_seeder", seeder_spy)
        s2 = cli_train.main(_stage2(synth, outd, "--folder_pre_trained_cl",
                                    s1["outd"]) + cpu)
    return dict(s1=s1, s2=s2, **got)


def test_cli_seeds_from_the_seeder_snapshot(cli_run):
    step, snap = ckpt.load_best_model(os.path.join(cli_run["s1"]["outd"],
                                                   C.BEST_LOC))
    assert cli_run["s2"]["seeder_step"] == step
    want = {f"{comp}.{k}": v for comp, sd in snap["components"].items()
            for k, v in sd.items()}
    assert set(cli_run["classifier"]) == set(want)
    for k, v in want.items():
        assert torch.equal(cli_run["classifier"][k], v), k
    train = cli_run["s2"]["records"]["train"]
    assert [r["steps"] for r in train] == [3] and np.isfinite(train[0]["loss"])
    assert len(cli_run["cams"]) == 3
    assert all(float(c.amax(dim=(1, 2)).min()) > 0.0 for c in cli_run["cams"])
