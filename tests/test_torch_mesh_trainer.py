"""The STD_CL Trainer and the CLIs on several ranks (spawned over gloo;
tests/torch_dist.py), on the synthetic set at crop 32.

- 2 ranks (mesh_dp 2, 3 frames a rank) against 1 rank (6 frames) and
  against JAX's Trainer at mesh_dp=2 (global batch 6) from the same
  weights: the val pass before training, one epoch and the val pass
  after.  A rank's shard holds every dp-th sample, so a step's global
  batch holds the same frames as the one-rank step, in another order
  (STD_CL's loss does not depend on it).  At the same weights the eval
  counters are bit-equal to one rank's, each image counted once; after
  the epoch (weights within 1e-5) and against JAX, within one image.
- mesh_dp 2 x mesh_mp 2 (4 ranks: the head's fc in class slices of 5)
  against JAX's Trainer at mesh_dp=2, mesh_mp=2 (its head sharded
  P(None, 'mp'), test_trainer_mesh.py's mp setting).
Tolerances: JAX's mesh test's (tests/test_trainer_mesh.py): the epoch
loss within rel 1e-4, parameters within 5e-4.
"""
import numpy as np
import pytest
import torch

from torch_dist import Ranks
import torch_mesh_ranks as ranks
from torch_port_fixtures import jax_classifier, jax_variables
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, finalize, get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.folds import load_split_metadata as jload_md
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.synthetic import make_synthetic_dataset
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JTransform
from tcam_wsol_video_tpu.engine.trainer import Trainer as JTrainer
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
PARAM_ATOL = 5e-4
# 2 ranks against 1: the same frames a step, fp32 sums in another order
# (measured 1.9e-5 on the parameters, a tenth of one rank's own fp32 gap
# to JAX here)
LOSS_RTOL_1 = 1e-5
PARAM_ATOL_1 = 5e-5
BATCH = 6          # the global batch: 2 steps over the 12 train shots
# the stage-1 recipe's lr (0.001; config_yaml/ytov1_stage1_cam.yaml): at
# 0.01 this 4-block model diverges in its second step (epoch loss 9.2)
# and one rank of the port already lies 4e-3 from JAX's single device
# there (fp32 conditioning, not the mesh; 2.4e-4 at 0.001)
FLAGS = dict(task=C.STD_CL, arch=C.STDCLASSIFIER, crop_size=32,
             resize_size=40, eval_batch_size=8, max_epochs=1,
             compute_dtype="float32", eval_compute_dtype="float32",
             checkpoint_save=0, cam_curve_interval=0.05, log_every=0,
             fast_eval=False, lr=0.001)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("mesh_synth")))


def _targs(tmp, dp, mp, batch):
    return TCAMConfig(**FLAGS, batch_size=batch, mesh_dp=dp, mesh_mp=mp,
                      outd=str(tmp), exp_id=f"dp{dp}mp{mp}")


def _jax_trainer(synth, tmp, variables, dp, mp):
    cfg = get_config(JC.YTOV1)
    cfg.update(FLAGS, batch_size=BATCH, mesh_dp=dp, mesh_mp=mp,
               num_workers=1, outd=str(tmp), exp_id=f"jax{dp}{mp}")
    args = finalize(HParams(cfg))
    kc = JKeyChain(args.seed)

    def ds(split, train):
        return JDataset(jload_md(synth["metadata_root"], split),
                        synth["data_root"],
                        split, JC.YTOV1, JTransform(40, 32, train=train), kc,
                        crop_size=32)

    ds_tr, ds_v = ds("train", True), ds("val", False)
    tr = JTrainer(args, jax_classifier(), JPipeline(ds_tr, BATCH, kc,
                                                    num_workers=1),
                  {"val": (ds_v, JPipeline(ds_v, 8, kc, shuffle=False,
                                           num_workers=1))},
                  keychain=kc, init_variables=variables)
    evals = [tr.evaluate(0, "val")]
    m = tr.train_epoch(0)
    evals.append(tr.evaluate(1, "val"))
    state = flax_to_state_dict({"params": tr.state.params,
                                "batch_stats": tr.state.batch_stats})
    return tr, evals, m, state


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_exps")
    variables = jax_variables(jax_classifier(), seed=3)
    two = Ranks(ranks.std_cl_trainer, 2, _targs(tmp, 2, 1, BATCH // 2),
                variables, synth, 1)
    four = Ranks(ranks.std_cl_trainer, 4, _targs(tmp, 2, 2, BATCH // 2),
                 variables, synth, 1)
    jdp = _jax_trainer(synth, tmp, variables, 2, 1)
    jmp = _jax_trainer(synth, tmp, variables, 2, 2)
    one = ranks.std_cl_trainer(0, 1, _targs(tmp, -1, 1, BATCH), variables,
                               synth, 1)
    return dict(one=one, two=two.join(), four=four.join(), jdp=jdp, jmp=jmp)


def _assert_state(states, want, atol):
    for st in states:
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                assert int(st[k]) == int(v), k
                continue
            np.testing.assert_allclose(st[k], v, rtol=0, atol=atol,
                                       err_msg=k)


def test_two_ranks_match_one_rank(runs):
    one, two = runs["one"], runs["two"]
    for r in two:
        # at the same weights: bit-equal counters, each image once
        assert r["evals"][0] == one["evals"][0]
        # after the epoch (weights 1e-5 apart) one image's box may flip
        after, want = r["evals"][1], one["evals"][1]
        assert after["n_images"] == want["n_images"] == 24
        assert after["classification"] == want["classification"]
        for k in ("localization", "maxboxacc_30", "maxboxacc_50",
                  "maxboxacc_70"):
            assert after[k] == pytest.approx(want[k], abs=100.0 / 24), k
        assert r["train"][0]["n"] == one["train"][0]["n"] == 12
        assert r["train"][0]["steps"] == one["train"][0]["steps"] == 2
        assert r["train"][0]["classification"] == \
            one["train"][0]["classification"]
        assert r["train"][0]["loss"] == pytest.approx(
            one["train"][0]["loss"], rel=LOSS_RTOL_1)
    for st in two[1:]:
        for k, v in two[0]["state"].items():
            np.testing.assert_array_equal(st["state"][k], v, k)
    _assert_state([two[0]["state"]], one["state"], PARAM_ATOL_1)


@pytest.mark.parametrize("run", ["two", "four"])
def test_std_cl_epoch_and_eval_match_jax_mesh(runs, run):
    tr, jevals, jm, jstate = runs["jdp" if run == "two" else "jmp"]
    assert dict(tr.mesh.shape) == {"dp": 2, "mp": 1 if run == "two" else 2}
    for r in runs[run]:
        for got, want in zip(r["evals"], jevals):
            assert got["n_images"] == want["n_images"]
            assert got["classification"] == pytest.approx(
                want["classification"])
            assert got["localization"] == pytest.approx(
                want["localization"], abs=100.0 / want["n_images"])
        assert r["train"][0]["loss"] == pytest.approx(jm["loss"],
                                                      rel=LOSS_RTOL)
        assert r["train"][0]["classification"] == pytest.approx(
            jm["classification"])
    _assert_state([r["state"] for r in runs[run]], jstate, PARAM_ATOL)


def test_mp_ranks_hold_their_class_slice(runs):
    assert [r["fc_rows"] for r in runs["four"]] == [(5, 2048)] * 4
    assert runs["two"][0]["fc_rows"] == (10, 2048)
    # the full head in every rank's state, equal on all four
    for r in runs["four"][1:]:
        for k, v in runs["four"][0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, k)


@pytest.mark.parametrize("run", ["two", "four"])
def test_checkpoint_holds_the_full_head_and_resumes(runs, run):
    """The rolling checkpoint holds the full (10, 2048) head and its
    momentum whatever the layout; a fresh trainer on the same mesh loads
    it back to the same parameters and momentum on every rank."""
    for r in runs[run]:
        res = r["resumed"]
        assert res["saved_fc"] == (10, 2048)
        assert res["saved_fc_momentum"] == [(10, 2048)]
        assert res["same_params"] and res["same_momentum"]
        assert res["step"] == 2
