"""chip_dress_rehearsal.py on the CPU at a tiny size: the chain of
cmds/e2e_dress_rehearsal_tpu.sh through the port's CLIs (stage 1, the
dump, stage 2 on the landmark CRF, evaluate twice), its record and the
summary over seeds.  The card's run uses the script's sizes; here the set
has 3 classes of 32 px crops, each stage one epoch, stage 2 10 seeds (the
script's 1000 do not fit a 32 x 32 frame) and ResNet-50 cut to one block
a stage."""
import json

import pytest
import torch

import chip_dress_rehearsal as dress
from tcam_wsol_video_tpu_torch.models import factory
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL

torch.set_num_threads(1)

TINY = dict(n_classes=3, n_videos_per_class=2, n_shots_per_video=2,
            n_frames_per_shot=4, frame_hw=(48, 64))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dress")
    flags = list(dress.STAGE2_FLAGS)
    for key in ("--sl_tc_min", "--sl_tc_max"):
        flags[flags.index(key) + 1] = "10"
    recs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dress, "STAGE2_FLAGS", flags)
        mp.setattr(factory, "resnet50_wsol",
                   lambda: ResNetWSOL(layers=(1, 1, 1, 1)))
        for seed in (0, 1):
            rec = dress.run(seed, "bfloat16", str(root / f"work{seed}"),
                            device="cpu", data=TINY, epochs=(1, 1), crop=32,
                            resize=40)
            path = root / f"dress_bfloat16_seed{seed}.json"
            path.write_text(json.dumps(rec))
            recs.append((rec, str(path)))
    return recs


def test_run_records_both_stages_and_evaluate(records):
    rec, _ = records[0]
    assert rec["compute_dtype"] == "bfloat16" and rec["device"] == "cpu"
    for stage in ("stage1", "stage2"):
        assert len(rec[stage]["epochs"]) == 1
        test = rec[stage]["test"]["best_localization"]
        assert test["n_images"] > 0
        assert all(0.0 <= test[str(s)] <= 100.0 for s in dress.IOUS)
        assert rec[stage]["median_step_ms"] > 0
    assert rec["dump"]["n_frames"] == 3 * 2 * 2 * 4
    # evaluate at the trainer's interval and batch equals its test pass
    # (under the script's --h2d_transfer uint8 evaluate reads float
    # pixels and the trainer rounded ones, as in JAX: on this set no box
    # moves)
    assert rec["evaluate"]["matches_trainer"]
    assert max(rec["evaluate"]["gap_to_trainer"].values()) == 0.0
    assert rec["evaluate"]["final"]["interval"] == dress.FINAL_INTERVAL
    # on the CPU the landmark CRF runs its plain versions: the counts
    # show the route (the card's run requires kernels only)
    launches = rec["stage2"]["launches"]
    assert launches["knm_build"]["plain"] >= rec["stage2"]["steps"]
    assert launches["bilateral_exact"] == {"kernel": 0, "plain": 0}


def test_summary_spreads_over_seeds(records):
    out = dress.summarize([p for _, p in records])
    assert list(out) == ["bfloat16"]
    assert sorted(out["bfloat16"]["seeds"]) == [0, 1]
    spread = out["bfloat16"]["spread"]["stage2_50"]
    vals = [r["stage2"]["test"]["best_localization"]["50"]
            for r, _ in records]
    assert spread["min"] == min(vals) and spread["max"] == max(vals)


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dress.main(["--seed", "0"]) == 2
    assert capsys.readouterr().out == ""
