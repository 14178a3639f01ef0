"""Port parity and behaviour of the trainer slice on the CPU: the LR
schedules, the ELB anneal and DecayTemp against the JAX functions epoch by
epoch; checkpoints and snapshots round trip; a resumed run continues at
the same step, ELB t and weights as an uninterrupted one; the CLI trains
2 epochs and writes its meters, snapshots and test results.
"""
import json
import os

import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.cams.temporal import DecayTemp as JDecayTemp
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.engine.lr import build_lr_fn as jbuild_lr_fn
from tcam_wsol_video_tpu.losses.elb import update_t as jupdate_t
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import (TCAMConfig, parse_args,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.synthetic import make_stand_in_cam_store
from tcam_wsol_video_tpu_torch.engine.lr import build_lr_fn
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer, set_lr
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.losses.elb import update_t
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM

torch.set_num_threads(1)

EPOCHS = range(0, 25)


@pytest.mark.parametrize("sched,kw", [
    ("mystep", dict(step_size=3, gamma=0.5, min_lr=1e-3)),
    ("step", dict(step_size=4, gamma=0.1)),
    ("constant", {}),
    ("cosine", dict(t_max=10, min_lr=1e-4)),
    ("mycosine", dict(lr_coef=0.5, max_epochs=20, min_lr=1e-5)),
    ("multistep", dict(lr_milestones=[3, 9, 15], gamma=0.3))])
def test_lr_schedules_match(sched, kw):
    args = TCAMConfig(lr=0.01, lr_scheduler=sched, **kw)
    fn, jfn = build_lr_fn(args), jbuild_lr_fn(args)
    assert [fn(e) for e in EPOCHS] == [jfn(e) for e in EPOCHS]


def test_elb_anneal_matches():
    t, jt = 1.0, 1.0
    for _ in range(300):
        t = update_t(t, 1.01, 10.0)
        jt = jupdate_t(jt, 1.01, 10.0)
        assert t == float(jt)
    assert t == pytest.approx(10.0)


@pytest.mark.parametrize("t,min_t,switch,tech", [
    (0.0, 0.0, -1, C.SEED_WEIGHTED), (2.0, 0.5, 4, C.SEED_WEIGHTED),
    (3.0, 0.0, 0, C.SEED_WEIGHTED), (1.5, 1.5, 2, C.SEED_UNIFORM)])
def test_decay_temp_matches(t, min_t, switch, tech):
    kw = dict(sl_tc_knn_t=t, sl_tc_min_t=min_t, sl_tc_knn=1,
              sl_tc_knn_mode=C.TIME_BEFORE,
              sl_tc_knn_epoch_switch_uniform=switch, sl_tc_seed_tech=tech)
    dt, jdt = DecayTemp(**kw), JDecayTemp(**kw)
    for e in range(8):
        dt.set_epoch(e)
        jdt.set_epoch(e)
        assert (dt.t, dt.seed_tech) == (jdt.t, jdt.seed_tech), e


def _small_model(seed: int = 0) -> UnetTCAM:
    torch.manual_seed(seed)
    return UnetTCAM(ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10,
                    freeze_cl=True)


def test_set_lr_keeps_the_classifier_ratio():
    opt = build_optimizer(stage2_tcam_recipe(), _small_model(), 0.01)
    set_lr(opt, 0.5)
    assert [g["lr"] for g in opt.param_groups] == [0.5, 5.0]


def test_checkpoint_round_trip(tmp_path):
    args = stage2_tcam_recipe()
    model = _small_model(1)
    state = TrainState(model, build_optimizer(args, model, 0.01),
                       elb_t=1.0201, step=0, epoch=3)
    x = torch.randn(2, 32, 32, 3)
    for step in (4, 8, 12):
        state.step = step
        model(x)["fcams"].sum().backward()
        state.optimizer.step()
        ckpt.save_checkpoint(str(tmp_path), state)
    assert len(ckpt.keep_last_n_checkpoints(str(tmp_path), 2)) == 1
    step, payload = ckpt.find_last_checkpoint(str(tmp_path))
    assert step == 12
    other = _small_model(2)
    restored = TrainState(other, build_optimizer(args, other, 0.01))
    ckpt.restore_checkpoint(restored, payload)
    assert (restored.step, restored.epoch, restored.elb_t) == (12, 3, 1.0201)
    for (k, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert restored.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()

    best = str(tmp_path / C.BEST_LOC)
    ckpt.save_best_model(best, 4, model, extra={"epoch": 0, "elb_t": 1.01})
    ckpt.save_best_model(best, 8, model, extra={"epoch": 1, "elb_t": 1.02})
    assert os.listdir(best) == ["8_best_model.pt"]
    step, snap = ckpt.load_best_model(best)
    assert step == 8 and snap["extra"] == {"epoch": 1, "elb_t": 1.02,
                                           "step": 8}
    assert set(snap["components"]) == {"encoder", "classification_head",
                                       "decoder", "segmentation_head"}
    fresh = _small_model(3)
    ckpt.load_components(fresh, snap["components"],
                         only=["encoder", "classification_head"])
    assert torch.equal(fresh.encoder.conv1.weight, model.encoder.conv1.weight)
    assert not torch.equal(fresh.segmentation_head.conv.weight,
                           model.segmentation_head.conv.weight)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    out = jmake(root, frame_hw=(90, 120))
    make_stand_in_cam_store(out["metadata_root"], os.path.join(root, "cams"),
                            seed=1)
    return root


def _flags(root, outd, epochs, ckpt_save=0):
    return ["--task", "TCAM", "--arch", "UnetTCAM", "--data_root", root,
            "--metadata_root", os.path.join(root, "folds"),
            "--std_cams_folder", os.path.join(root, "cams"),
            "--crop_size", "32", "--resize_size", "40", "--batch_size", "4",
            "--eval_batch_size", "8", "--max_epochs", str(epochs),
            "--cam_curve_interval", "0.05", "--lr", "0.01",
            "--freeze_cl", "true", "--sl_tc", "true", "--sl_tc_min", "1",
            "--sl_tc_max", "1", "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6",
            "--sl_tc_min_p", "0.1", "--sl_tc_seed_tech", "seed_weighted",
            "--sl_tc_use_roi", "true", "--sl_tc_knn", "1",
            "--sl_tc_knn_mode", "before", "--sl_tc_knn_t", "0.0",
            "--crf_tc", "true", "--max_sizepos_tc", "true",
            "--max_sizepos_tc_lambda", "0.01", "--elb_init_t", "1.0",
            "--elb_max_t", "10.0", "--elb_mulcoef", "1.01",
            "--checkpoint_save", str(ckpt_save), "--outd", outd,
            "--exp_id", "run"]


def _trainer(root, outd, epochs, ckpt_save):
    args, _ = parse_args(_flags(root, outd, epochs, ckpt_save))
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, "cpu")
    return Trainer(args, _small_model(), train_pipe, eval_pipes,
                   keychain=kc, device="cpu")


def test_resumed_run_continues(synth, tmp_path):
    straight = _trainer(synth, str(tmp_path / "a"), 2, 0)
    straight.fit()
    first = _trainer(synth, str(tmp_path / "b"), 1, 100)
    first.fit()
    assert first.state.step == 3
    resumed = _trainer(synth, str(tmp_path / "b"), 2, 100)
    assert resumed.load_checkpoint_if_any() == 1
    assert (resumed.state.step, resumed.state.elb_t) == \
        (3, first.state.elb_t)
    resumed.fit()
    assert resumed.state.step == straight.state.step == 6
    assert resumed.state.elb_t == straight.state.elb_t == \
        update_t(update_t(1.0, 1.01, 10.0), 1.01, 10.0)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert resumed.meters["val_localization"].history == \
        straight.meters["val_localization"].history


def test_cli_trains_two_epochs(synth, tmp_path):
    out = cli_train.main(_flags(synth, str(tmp_path), 2) + ["--device",
                                                           "cpu"])
    train = out["records"]["train"]
    assert [r["steps"] for r in train] == [3, 3]
    assert [r["elb_t"] for r in train] == [update_t(1.0, 1.01, 10.0),
                                           update_t(update_t(1.0, 1.01,
                                                             10.0),
                                                    1.01, 10.0)]
    assert all(np.isfinite(r["loss"]) for r in train)
    evals = out["records"]["eval"]
    assert [e["split"] for e in evals] == ["val"] * 3 + ["test"] * len(
        out["test"])
    res = out["test"][C.BEST_LOC]
    assert res["n_images"] == 24
    for s in (30, 50, 70):
        assert 0.0 <= res[f"maxboxacc_{s}"] <= 100.0
    with open(os.path.join(out["outd"], "performances.json")) as f:
        perf = json.load(f)
    assert len(perf["meters"]["val_localization"]["history"]) == 3
    assert len(perf["meters"]["train_loss"]["history"]) == 2
    step, snap = ckpt.load_best_model(os.path.join(out["outd"], C.BEST_LOC))
    assert snap["extra"]["epoch"] == \
        perf["meters"]["val_localization"]["best_epoch"]
    assert snap["extra"]["step"] == step
    assert snap["extra"]["localization"] == \
        perf["meters"]["val_localization"]["best"]
    assert os.path.isfile(os.path.join(out["outd"], "passed.txt"))


def test_cli_refuses_cuda_without_a_card(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(_flags(synth, str(tmp_path), 1))


def test_parse_args_spellings():
    args, _ = parse_args(["--task", "TCAM", "--arch", "UnetTCAM",
                          "--sl_tc", "True", "--iou_threshold_list",
                          "[30, 50]", "--knn_tc", "1", "--batch_size", "33",
                          "--sl_tc_knn", "1", "--sl_tc_knn_mode",
                          "before-after", "--lr", "1e-2"])
    assert args.sl_tc is True and args.iou_threshold_list == [30, 50]
    assert args.batch_size == 11 and args.lr == 0.01
    with pytest.raises(ValueError):
        parse_args(["--sl_tc_knn", "1"])
    with pytest.raises(SystemExit):
        parse_args(["--no_such_key", "1"])
