"""Port parity: the evaluation protocol (native box sweep binding,
BoxEvaluator, CamEvaluator) against the JAX package on the CPU.

The sweep and the counters are held exactly.  CamEvaluator is held
exactly on injected CAMs (the same function of the batch on both sides),
and on a transplanted UnetTCAM with a tolerance: the protocol renders
floor(cam * 255), so a CAM difference of one fp32 rounding can move a
pixel across a k/255 boundary and flip one image at one threshold.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import CROP, jax_model, jax_variables, torch_model
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data import folds as jfolds
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu.engine import evaluator as jevaluator
from tcam_wsol_video_tpu.metrics import native_sweep as jsweep
from tcam_wsol_video_tpu.metrics import wsol as jwsol
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import folds
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
from tcam_wsol_video_tpu_torch.engine import evaluator
from tcam_wsol_video_tpu_torch.metrics import native_sweep, wsol

torch.set_num_threads(1)

TAUS = np.arange(0.0, 1.0, 0.01)


def _cams(seed: int, n: int = 12, h: int = 32, w: int = 40):
    """Uniform noise (many fragments) and smooth blobs with holes."""
    rng = np.random.default_rng(seed)
    noise = rng.random((n // 2, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    blobs = []
    for _ in range(n - n // 2):
        cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
        r = rng.uniform(3, 10)
        b = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        b[int(cy) - 1:int(cy) + 1, int(cx) - 1:int(cx) + 1] *= 0.3
        blobs.append(b.astype(np.float32))
    cams = np.concatenate([noise, np.stack(blobs)])
    gts = [np.asarray([[rng.integers(0, 10), rng.integers(0, 10),
                        rng.integers(15, w), rng.integers(15, h)]
                       for _ in range(int(rng.integers(1, 4)))], np.float32)
           for _ in range(n)]
    return cams, gts


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_binding_matches(seed):
    cams, gts = _cams(seed)
    best, nbox = native_sweep.sweep_best_iou(cams, TAUS, gts)
    jbest, jnbox = jsweep.sweep_best_iou(cams, TAUS, gts)
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_array_equal(nbox, jnbox)
    for i in (0, 7):
        for tau in (0.1, 0.5, 0.83):
            np.testing.assert_array_equal(
                native_sweep.sweep_boxes_at(cams[i], tau),
                jsweep.sweep_boxes_at(cams[i], tau))


def test_box_evaluator_matches():
    cams, gts = _cams(2, n=16)
    best, _ = native_sweep.sweep_best_iou(cams, TAUS, gts)
    rng = np.random.default_rng(3)
    ev = wsol.BoxEvaluator(TAUS, (30, 50, 70))
    jev = jwsol.BoxEvaluator(TAUS, (30, 50, 70))
    for i in range(len(cams)):
        target = int(rng.integers(0, 10))
        preds = rng.permutation(10)
        ev.accumulate_best_iou(best[i], target, preds)
        jev.accumulate_best_iou(best[i], target, preds)
    assert ev.compute() == jev.compute()
    assert ev.best_tau_list == jev.best_tau_list
    assert (ev.top1, ev.top5) == (jev.top1, jev.top5)
    for s in (30, 50, 70):
        np.testing.assert_array_equal(ev.curves[s], jev.curves[s])
    preds, targets = rng.integers(0, 10, 50), rng.integers(0, 10, 50)
    assert wsol.classification_accuracy(preds, targets) == \
        jwsol.classification_accuracy(preds, targets)


def test_threshold_lists_and_fast_rule(monkeypatch):
    for iv in (0.001, 0.01, 0.05):
        np.testing.assert_array_equal(evaluator.cam_threshold_list(iv),
                                      jevaluator.cam_threshold_list(iv))

    class _Big:
        def __len__(self):
            return C.FAST_EVAL_SAMPLES_THRESHOLD + 1

    args = TCAMConfig(task=C.TCAM, cam_curve_interval=0.01)
    monkeypatch.setattr(evaluator, "make_cam_eval_step", lambda m, a: None)
    fast = evaluator.CamEvaluator(None, args, _Big(), None, C.VALIDSET,
                                  fast=True)
    test = evaluator.CamEvaluator(None, args, _Big(), None, C.TESTSET,
                                  fast=True)
    np.testing.assert_array_equal(fast.taus, evaluator.cam_threshold_list(
        C.VALID_FAST_CAM_CURVE_INTERVAL))
    np.testing.assert_array_equal(test.taus,
                                  evaluator.cam_threshold_list(0.01))


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    out = jmake(root, frame_hw=(90, 120))
    return out


def _args():
    targs = TCAMConfig(task=C.TCAM, arch=C.UNETTCAM, crop_size=CROP,
                       eval_batch_size=5, cam_curve_interval=0.01,
                       freeze_cl=True)
    cfg = get_config(C.YTOV1)
    cfg.update(targs.__dict__)
    cfg.update(compute_dtype="float32", eval_compute_dtype="float32",
               eval_sweep="host")
    return targs, HParams(cfg)


def _evaluators(val_split, model, jmodel, targs, jargs):
    md = folds.load_split_metadata(val_split["metadata_root"], "val")
    jmd = jfolds.load_split_metadata(val_split["metadata_root"], "val")
    ds = WSOLVideoDataset(md, val_split["data_root"], C.VALIDSET, C.YTOV1,
                          PairedTransform(40, CROP, train=False),
                          KeyChain(0), crop_size=CROP)
    jds = JDataset(jmd, val_split["data_root"], C.VALIDSET, C.YTOV1,
                   JPT(40, CROP, train=False), JKeyChain(0), crop_size=CROP)
    ev = evaluator.CamEvaluator(
        model, targs, ds, DataPipeline(ds, 5, KeyChain(0), shuffle=False,
                                       device="cpu"), C.VALIDSET)
    jev = jevaluator.CamEvaluator(
        jmodel, jargs, jds, JPipeline(jds, 5, JKeyChain(0), shuffle=False),
        C.VALIDSET)
    return ev, jev


_SCALARS = ("maxboxacc_30", "maxboxacc_50", "maxboxacc_70", "top1_loc_30",
            "top1_loc_50", "top1_loc_70", "top5_loc_30", "top5_loc_50",
            "top5_loc_70", "localization", "classification", "n_images")


def test_cam_evaluator_exact_on_injected_cams(val_split):
    """Both evaluators get the same CAMs and logits, exact functions of
    the (bit-equal) batch: every output must be equal."""
    targs, jargs = _args()
    ev, jev = _evaluators(val_split, torch.nn.Identity(),
                          jax_model(), targs, jargs)

    def fake(images, raw=None):
        cam = (images[..., 0] * 0.125 + 0.5).clamp(0.0, 1.0)
        return cam, images[:, 0, :10, 0]

    def jfake(params, bstats, images, targets, key, raw=None):
        cam = jnp.clip(images[..., 0] * 0.125 + 0.5, 0.0, 1.0)
        return cam, images[:, 0, :10, 0]

    ev.eval_step = fake
    jev.eval_step = jfake
    res = ev.run()
    jres = jev.run({"params": {}, "batch_stats": {}},
                   jax.random.PRNGKey(0))
    assert res["n_images"] == 24
    for k in _SCALARS:
        assert res[k] == jres[k], k
    assert res["best_tau"] == jres["best_tau"]
    for s in (30, 50, 70):
        np.testing.assert_array_equal(res["curves"][s], jres["curves"][s])
    assert res["timing"]["batches"] == 5


def test_cam_evaluator_on_transplanted_model(val_split):
    """Classification equal; each MaxBoxAcc within one image's share
    (100 / 24) of the JAX value."""
    targs, jargs = _args()
    jm = jax_model()
    variables = jax_variables(jm, seed=5)
    model = torch_model(variables)
    ev, jev = _evaluators(val_split, model, jm, targs, jargs)
    res = ev.run()
    jres = jev.run(variables, jax.random.PRNGKey(0))
    assert res["n_images"] == jres["n_images"] == 24
    assert res["classification"] == jres["classification"]
    assert max(res[f"maxboxacc_{s}"] for s in (30, 50, 70)) > 0
    for s in (30, 50, 70):
        assert abs(res[f"maxboxacc_{s}"] - jres[f"maxboxacc_{s}"]) \
            <= 100.0 / 24 + 1e-9, s


def test_gt_cap_warns(val_split, caplog):
    targs, _ = _args()
    md = folds.load_split_metadata(val_split["metadata_root"], "val")
    iid = md.image_ids[0]
    md.boxes[iid] = md.boxes[iid] * 10
    ds = WSOLVideoDataset(md, val_split["data_root"], C.VALIDSET, C.YTOV1,
                          PairedTransform(40, CROP, train=False),
                          KeyChain(0), crop_size=CROP)
    ev = evaluator.CamEvaluator(torch.nn.Identity(), targs, ds, None,
                                C.VALIDSET)
    with caplog.at_level(logging.WARNING):
        boxes, valid = ev._gt_batch([iid, md.image_ids[1]])
    assert valid.sum(1).tolist() == [8, 1]
    assert any("only the first 8" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(boxes[0, :8],
                                  ds.eval_gt_boxes(iid)[:8])
