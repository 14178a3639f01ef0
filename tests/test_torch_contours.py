"""Port parity of the box protocols' contours (csrc/contours.cpp through
ops/contours.py, metrics/wsol.scoremap_to_boxes) against the JAX package's
cv2 calls, on the CPU.

The tracer is held point for point against cv2.findContours(RETR_TREE,
CHAIN_APPROX_SIMPLE) on the same masks, its order and parents included
(the independent reference that fixes cv2's return order), and
scoremap_to_boxes box for box against JAX's under both protocols:
Hypothesis-drawn maps of 8-48 px with few levels (plateaus, many
components, holes), blurred CAM-like maps at 224 px, and the edge cases
(an empty mask, single pixels, diagonal-only contacts, a component inside
a hole, components on the border, equal-area ties).  BoxEvaluator under
the single-largest-contour protocol and cli.evaluate --multi_contour_eval
false are held against JAX's evaluator exactly.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data import folds as jfolds
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.pipeline import DataPipeline as JPipeline
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu.engine import evaluator as jevaluator
from tcam_wsol_video_tpu.metrics import wsol as jwsol
from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
from tcam_wsol_video_tpu_torch.engine import evaluator
from tcam_wsol_video_tpu_torch.metrics import native_sweep, wsol
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.ops import contours

torch.set_num_threads(1)

TAUS = np.arange(0.0, 1.0, 0.01)


def _level_map(seed: int, h: int, w: int, n_levels: int) -> np.ndarray:
    """A map of few levels: random blocks (plateaus, holes, many
    components) with salt."""
    rng = np.random.default_rng(seed)
    bh, bw = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    small = rng.integers(0, n_levels, (-(-h // bh), -(-w // bw)))
    m = np.repeat(np.repeat(small, bh, 0), bw, 1)[:h, :w]
    salt = rng.random((h, w)) < 0.05
    m = np.where(salt, rng.integers(0, n_levels, (h, w)), m)
    return (m / (n_levels - 1)).astype(np.float32)


def _blurred(seed: int, size: int = 224) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = cv2.GaussianBlur(rng.random((size, size)).astype(np.float32),
                         (0, 0), float(rng.uniform(2, 12)))
    return ((m - m.min()) / (m.max() - m.min())).astype(np.float32)


def _edge_maps():
    z = np.zeros((12, 14), np.float32)
    single = z.copy()
    single[5, 6] = 1.0
    diag = z.copy()
    for i in range(5):
        diag[2 + i, 3 + i] = 1.0          # diagonal-only contacts
    diag[2, 9] = diag[3, 10] = 0.6
    nested = z.copy()
    nested[1:11, 1:13] = 1.0
    nested[3:9, 3:11] = 0.0               # a hole ...
    nested[5:7, 5:9] = 0.8                # ... holding a component
    border = z.copy()
    border[0, :] = 1.0
    border[:, -1] = 0.7
    border[-3:, :3] = 0.4
    ties = z.copy()
    ties[1:4, 1:4] = 1.0                  # two equal squares
    ties[7:10, 8:11] = 1.0
    lines = z.copy()
    lines[2, 1:8] = 1.0                   # area-0 components only
    lines[6:11, 4] = 1.0
    lines[9, 10] = 1.0
    full = np.ones((6, 7), np.float32)
    return {"empty": z, "single": single, "diagonal": diag,
            "nested": nested, "border": border, "ties": ties,
            "lines": lines, "full": full}


def _assert_boxes_equal(m: np.ndarray, taus, multi: bool) -> None:
    want, want_n = jwsol.scoremap_to_boxes(m, taus, multi)
    got, got_n = wsol.scoremap_to_boxes(m, taus, multi)
    assert got_n == want_n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


_maps = st.tuples(st.integers(0, 2 ** 31 - 1), st.integers(8, 48),
                  st.integers(8, 48), st.integers(2, 5))
# no example database: the run leaves no files behind
_hyp = settings(max_examples=60, deadline=None, database=None,
                suppress_health_check=[HealthCheck.too_slow])


@_hyp
@given(_maps, st.booleans())
def test_boxes_match_on_drawn_maps(spec, multi):
    _assert_boxes_equal(_level_map(*spec), TAUS, multi)


@_hyp
@given(_maps, st.integers(0, 254))
def test_tracer_matches_cv2_points_order_and_parents(spec, level):
    """The tracer's borders against cv2.findContours' on the same mask:
    the same points in the same order, the same parents."""
    img8 = (_level_map(*spec) * 255).astype(np.uint8)
    got, meta = contours.trace(img8, level)
    _, binary = cv2.threshold(img8, level, 255, cv2.THRESH_BINARY)
    want, hier = cv2.findContours(binary, cv2.RETR_TREE,
                                  cv2.CHAIN_APPROX_SIMPLE)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.reshape(-1, 2))
    if want:
        np.testing.assert_array_equal(meta[:, 0], hier[0][:, 3])


@pytest.mark.parametrize("multi", [False, True])
def test_boxes_match_on_blurred_224_maps(multi):
    for seed in range(3):
        _assert_boxes_equal(_blurred(seed), TAUS, multi)


@pytest.mark.parametrize("name", sorted(_edge_maps()))
@pytest.mark.parametrize("multi", [False, True])
def test_boxes_match_on_edge_cases(name, multi):
    m = _edge_maps()[name]
    _assert_boxes_equal(m, TAUS, multi)
    if name == "empty":
        boxes, counts = wsol.scoremap_to_boxes(m, TAUS, multi)
        assert counts == [1] * len(TAUS)
        assert all((b == 0).all() for b in boxes)


def test_areas_match_cv2():
    """The doubled areas are contourArea's (a line or a pixel has 0)."""
    for name, m in _edge_maps().items():
        img8 = (m * 255).astype(np.uint8)
        rows = contours.sweep(img8, np.asarray([0, 100]), multi=True)
        for li, level in enumerate((0, 100)):
            _, binary = cv2.threshold(img8, level, 255, cv2.THRESH_BINARY)
            cs, _ = cv2.findContours(binary, cv2.RETR_TREE,
                                     cv2.CHAIN_APPROX_SIMPLE)
            got = rows[rows[:, 0] == li]
            assert [r[5] / 2.0 for r in got] == \
                [cv2.contourArea(c) for c in cs], name
            assert [tuple(r[1:5]) for r in got] == \
                [cv2.boundingRect(c) for c in cs], name


def test_multi_contour_boxes_agree_with_native_sweep():
    taus = np.arange(0.0, 1.0, 0.05)
    maps = [_blurred(5, 64), _level_map(3, 40, 36, 4),
            _edge_maps()["nested"]]
    for m in maps:
        boxes, _ = wsol.scoremap_to_boxes(m, taus, True)
        for tau, b in zip(taus, boxes):
            native = native_sweep.sweep_boxes_at(m, float(tau))
            if len(native) == 0:
                native = np.zeros((1, 4), np.float32)
            assert sorted(map(tuple, b.tolist())) == \
                sorted(map(tuple, native.astype(np.float64).tolist()))


def test_box_evaluator_single_contour_matches():
    rng = np.random.default_rng(0)
    ev = wsol.BoxEvaluator(TAUS, multi_contour_eval=False)
    jev = jwsol.BoxEvaluator(TAUS, multi_contour_eval=False)
    for i in range(16):
        m = _blurred(i, 48) if i % 2 else _level_map(i, 40, 48, 3)
        gt = np.asarray([[rng.integers(0, 20), rng.integers(0, 15),
                          rng.integers(20, 48), rng.integers(15, 40)]],
                        np.float32)
        preds = rng.permutation(10)
        ev.accumulate(m, gt, int(i % 10), preds)
        jev.accumulate(m, gt, int(i % 10), preds)
    got, want = ev.compute(), jev.compute()
    assert got == want and max(got) > 0
    assert ev.top1 == jev.top1 and ev.top5 == jev.top5
    assert ev.best_tau_list == jev.best_tau_list
    for s in (30, 50, 70):
        np.testing.assert_array_equal(ev.num_correct[s], jev.num_correct[s])


def _fake_cam(images, raw=None, targets=None, generator=None):
    cam = (images[..., 0] * 0.125 + 0.5).clamp(0.0, 1.0)
    return cam, images[:, 0, :10, 0]


def _jfake_cam(params, bstats, images, targets, key, raw=None):
    return (jnp.clip(images[..., 0] * 0.125 + 0.5, 0.0, 1.0),
            images[:, 0, :10, 0])


def test_cli_evaluate_single_contour_matches_jax(tmp_path, monkeypatch):
    """cli.evaluate --multi_contour_eval false on a snapshot, its CAMs a
    function of the (bit-equal) batch on both sides, against JAX's
    evaluator on the same split: every result equal."""
    out = jmake(str(tmp_path / "data"), frame_hw=(90, 120))
    flags = dict(task=C.STD_CL, crop_size=32, resize_size=40,
                 eval_batch_size=8, cam_curve_interval=0.01,
                 multi_contour_eval=False)
    model = create_model_from_args(TCAMConfig(**flags), device="cpu")
    exp = tmp_path / "exp"
    ckpt.save_best_model(str(exp / C.BEST_LOC), 3, model)
    monkeypatch.setattr(evaluator, "make_cam_eval_step",
                        lambda m, a: _fake_cam)
    res = cli_evaluate.main([
        "--device", "cpu", "--exp_dir", str(exp), "--data_root",
        out["data_root"].rsplit(os.sep, 1)[0], "--metadata_root",
        out["metadata_root"], "--crop_size", "32", "--resize_size", "40",
        "--eval_batch_size", "8", "--cam_curve_interval", "0.01",
        "--multi_contour_eval", "false"])

    cfg = get_config(C.YTOV1)
    cfg.update(flags)
    jargs = HParams(cfg)
    jmd = jfolds.load_split_metadata(out["metadata_root"], C.TESTSET)
    jds = JDataset(jmd, out["data_root"], C.TESTSET, C.YTOV1,
                   JPT(40, 32, train=False), JKeyChain(0), crop_size=32)
    jev = jevaluator.CamEvaluator(
        None, jargs, jds, JPipeline(jds, 8, JKeyChain(0), shuffle=False),
        C.TESTSET)
    jev.eval_step = _jfake_cam
    jres = jev.run({"params": {}, "batch_stats": {}},
                   jax.random.PRNGKey(0))
    assert res["n_images"] == jres["n_images"] > 0
    for k in ("maxboxacc_30", "maxboxacc_50", "maxboxacc_70",
              "top1_loc_50", "top5_loc_50", "localization",
              "classification"):
        assert res[k] == jres[k], k
    assert res["best_tau"] == jres["best_tau"]
    assert res["timing"]["sweep"] == "host"
