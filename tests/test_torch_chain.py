"""The port's two-stage chain on the CPU through the CLIs a user runs, as
cmds/e2e_synth224_tpu.sh chains the JAX ones: stage 1 (STD_CL, 1 epoch)
-> dump_cams -> stage 2 (TCAM over the dumped store, starting from stage
1's best-classification encoder and head, 1 epoch) -> evaluate at stage
2's best-localization snapshot.  A small synthetic set (48 frames of
90 x 120), crop 32, the full ResNet-50 with random weights; stage 2 draws
its own from another seed, so its encoder and head match stage 1's only
if the load took place.
"""
import json
import os

import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu_torch.cli import dump_cams, evaluate
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(1)


def _common(root):
    return ["--dataset", "YouTube-Objects-v1.0", "--data_root", root,
            "--metadata_root", os.path.join(root, "folds"),
            "--crop_size", "32", "--resize_size", "40",
            "--cam_curve_interval", "0.05", "--eval_batch_size", "8",
            "--log_every", "0"]


def _stage1(root):
    return _common(root) + [
        "--task", "STD_CL", "--batch_size", "4", "--max_epochs", "1",
        "--lr", "0.01", "--checkpoint_save", "0",
        "--outd", os.path.join(root, "exps"), "--exp_id", "s1"]


def _stage2(root, s1):
    return _common(root) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--batch_size", "4",
        "--max_epochs", "1", "--lr", "0.01", "--freeze_cl", "true",
        "--sl_tc", "true", "--sl_tc_min", "1", "--sl_tc_max", "1",
        "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6", "--sl_tc_min_p", "0.1",
        "--sl_tc_seed_tech", "seed_weighted", "--sl_tc_use_roi", "true",
        "--sl_tc_knn", "1", "--sl_tc_knn_mode", "before",
        "--sl_tc_knn_t", "0.0", "--crf_tc", "true",
        "--max_sizepos_tc", "true", "--max_sizepos_tc_lambda", "0.01",
        "--std_cams_folder", os.path.join(root, "cam_store"),
        "--folder_pre_trained_cl", s1, "--checkpoint_save", "0",
        "--seed", "1", "--outd", os.path.join(root, "exps"), "--exp_id", "s2"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chain"))
    make_synthetic_dataset(root, frame_hw=(90, 120), device="cpu")
    cpu = ["--device", "cpu"]
    s1 = cli_train.main(_stage1(root) + cpu)
    dump = dump_cams.main(_common(root) + [
        "--task", "STD_CL", "--exp_dir", s1["outd"],
        "--out", os.path.join(root, "cam_store")] + cpu)

    # the encoder and head of stage 2 right before and after the load
    loaded = {}
    load = cli_train.load_pretrained_classifier_weights

    def components(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()
                if k.startswith(("encoder.", "classification_head."))}

    def spy(args, model):
        loaded["before"] = components(model)
        load(args, model)
        loaded["after"] = components(model)

    mp = pytest.MonkeyPatch()
    mp.setattr(cli_train, "load_pretrained_classifier_weights", spy)
    try:
        s2 = cli_train.main(_stage2(root, s1["outd"]) + cpu)
    finally:
        mp.undo()
    ev = evaluate.main(_common(root) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--exp_dir", s2["outd"]]
        + cpu)
    return dict(root=root, s1=s1, dump=dump, s2=s2, loaded=loaded, ev=ev)


def test_stage1_trains_and_writes_its_snapshots(chain):
    s1 = chain["s1"]
    train = s1["records"]["train"]
    assert [r["steps"] for r in train] == [3]
    assert np.isfinite(train[0]["loss"])
    for tag in (C.BEST_LOC, C.BEST_CL):
        _, snap = ckpt.load_best_model(os.path.join(s1["outd"], tag))
        assert set(snap["components"]) == {"encoder", "classification_head"}
    with open(os.path.join(s1["outd"], "performances.json")) as f:
        perf = json.load(f)
    assert set(perf["test"]) == {C.BEST_LOC, C.BEST_CL}
    assert perf["test"][C.BEST_LOC]["n_images"] == 24
    assert os.path.isfile(os.path.join(s1["outd"], "passed.txt"))
    # both stages write under the same experiment tag
    assert os.path.dirname(s1["outd"]) == os.path.dirname(
        chain["s2"]["outd"])


def test_dump_stores_every_train_frame(chain):
    store = CamStore(os.path.join(chain["root"], "cam_store"))
    th = store.thresholds
    assert chain["dump"]["n_frames"] == len(th) == 48
    for fid, t in th.items():
        cam = store.load_cam(fid)
        assert cam.shape == (28, 28)
        assert 0.0 <= cam.min() and cam.max() <= 1.0 and 0.0 <= t <= 1.0


def test_stage2_starts_from_stage1_classifier(chain):
    _, snap = ckpt.load_best_model(os.path.join(chain["s1"]["outd"],
                                                C.BEST_CL))
    want = {f"{comp}.{k}": v for comp, sd in snap["components"].items()
            for k, v in sd.items()}
    before, after = chain["loaded"]["before"], chain["loaded"]["after"]
    assert set(before) == set(after) == set(want)
    # stage 2's own initial weights (another seed) are not stage 1's ...
    weights = [k for k, v in want.items() if v.dim() >= 2]
    assert len(weights) == 54          # 53 convolutions and the fc layer
    for k in weights:
        assert not torch.equal(before[k], want[k]), k
    # ... and the load replaced every tensor of both components
    for k, v in want.items():
        assert torch.equal(after[k], v), k
    assert [r["steps"] for r in chain["s2"]["records"]["train"]] == [3]


def test_evaluate_agrees_with_the_trainer_test_pass(chain):
    want = chain["s2"]["test"][C.BEST_LOC]
    got = chain["ev"]
    assert got["n_images"] == want["n_images"] == 24
    for k in ("maxboxacc_30", "maxboxacc_50", "maxboxacc_70",
              "classification", "localization"):
        assert got[k] == want[k], k


def test_evaluate_refuses_a_missing_snapshot(chain, tmp_path):
    with pytest.raises(FileNotFoundError, match="no best-model snapshot"):
        evaluate.main(_common(chain["root"]) + [
            "--task", "TCAM", "--arch", "UnetTCAM",
            "--exp_dir", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("cli", [dump_cams, evaluate],
                         ids=["dump_cams", "evaluate"])
def test_cli_refuses_cuda_without_a_card(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--exp_dir", str(tmp_path), "--out", str(tmp_path)]
                 if cli is dump_cams else ["--exp_dir", str(tmp_path)])
