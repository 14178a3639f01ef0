"""The production stage-2 CRF (crf_impl landmarks) against the benchmark's
plain Nystrom reference (benchmark/reference/nystrom.py), and the
recorder's landmark span and counters, on the CPU; one `cuda` test holds
the chunked route's CUDA graphs to the eager route's counts on the card.

- the program's landmark CRF energy and gradient (ops/crf.dense_crf_loss,
  method "landmarks") against the reference's at B 2, 32 x 32, M 64;
- the reference with a landmark at every pixel against the dense filter
  (benchmark/reference/losses.dense_filter): K (K + r I)^-1 K v - K v =
  -r K (K + r I)^-1 v, whose norm is at most r ||v||;
- a tiny run of the cell tcam_r50_landmarks.feed_nystrom through its
  runner is `correct`;
- crf.knm_builds is 2 a step, crf.knm_mb the K_nm and K_mm written,
  crf.solve_failed 0 and the span crf.landmarks once a step, per epoch, on
  both eager routes (one step a dispatch, and the chunked route's eager
  chunks on the CPU).
"""
import numpy as np
import pytest
import torch

from benchmark.reference import losses as ref_losses
from benchmark.reference import nystrom
from benchmark.tests import tiny, tiny_nystrom
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.synthetic import (make_stand_in_cam_store,
                                                      make_synthetic_dataset)
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.models import factory, resnet
from tcam_wsol_video_tpu_torch.ops import crf

torch.set_num_threads(1)

SIGMA_RGB, SIGMA_XY = 15.0, 100.0
RIDGE = nystrom.RIDGE
# the energy is a sum of B P K fp32 products on both sides: a few ulps
ENERGY_RTOL = 1e-6
# the gradient is -2 AS / B; the program's AS carries the fp32 norm
# expansion of each K entry (|f|^2 up to ~75 at sigma_rgb 15, so ~5e-6 of
# an entry) through the fp32 ridge solve; the reference is float64
# (measured 4.5e-6 to 8.6e-6 over 8 seeds)
GRAD_RTOL = 1e-4
# the reference at M = P against the fp32 dense filter: the gap is the
# ridge's term, ~1e-2 of AS, so dense_filter's fp32 rounding (~1e-7 of AS)
# is ~1e-5 of it at P = 64 (measured up to 4.5e-4 relative in norm)
RIDGE_TERM_RTOL = 2e-3
LANDMARKS = 64
EXACT_CRF = ref_losses.crf


def _inputs(seed: int, b: int = 2, side: int = 32):
    """Smooth frames (a 5 x 5 box blur of uniform noise) and logits."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.rand((b, 3, side, side), generator=g) * 255.0
    raw = torch.nn.functional.avg_pool2d(raw, 5, 1, 2)
    fcams = 2.0 * torch.randn((b, side, side, 2), generator=g)
    return raw.permute(0, 2, 3, 1).contiguous(), fcams


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_landmark_crf_matches_the_reference(seed):
    raw, fcams = _inputs(seed)
    ref_in = fcams.clone().requires_grad_(True)
    want = nystrom.crf(ref_in, raw, SIGMA_RGB, SIGMA_XY,
                       n_landmarks=LANDMARKS)
    want.backward()
    prog_in = fcams.clone().requires_grad_(True)
    got = crf.dense_crf_loss(raw, torch.softmax(prog_in, -1), SIGMA_RGB,
                             SIGMA_XY, method="landmarks",
                             n_landmarks=LANDMARKS)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=ENERGY_RTOL)
    gap = (prog_in.grad - ref_in.grad).norm() / ref_in.grad.norm()
    assert float(gap) <= GRAD_RTOL


def test_reference_grid_is_the_programs():
    for h, w, m in ((224, 224, 1024), (32, 32, 64), (45, 60, 100),
                    (8, 8, 64)):
        np.testing.assert_array_equal(nystrom.landmark_grid(h, w, m),
                                      crf._landmark_grid_indices(h, w, m))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_at_every_pixel_is_the_dense_filter_less_the_ridge(seed):
    g = torch.Generator().manual_seed(seed)
    raw = torch.rand((2, 8, 8, 3), generator=g) * 255.0
    vals = torch.softmax(torch.randn((2, 64, 2), generator=g), -1)
    feats = ref_losses.crf_features(raw, SIGMA_RGB, SIGMA_XY)
    idx = nystrom.landmark_grid(8, 8, 64)
    np.testing.assert_array_equal(idx, np.arange(64))
    gap = (nystrom.nystrom_filter(feats, vals, idx)
           - ref_losses.dense_filter(feats, vals)).double()
    for i in range(2):
        f, v = feats[i].double(), vals[i].double()
        k = torch.exp(-0.5 * torch.cdist(f, f) ** 2)
        term = -RIDGE * k @ torch.linalg.solve(
            k + RIDGE * torch.eye(64, dtype=torch.float64), v)
        assert float(gap[i].norm()) <= RIDGE * float(v.norm())
        assert float((gap[i] - term).norm() / term.norm()) \
            <= RIDGE_TERM_RTOL


def test_tiny_run_of_the_cell_is_correct(tmp_path):
    c = tiny.cell(tiny_nystrom.CELL, compute_dtype="float32")
    ctx = tiny_nystrom.run(c, str(tmp_path))
    assert ctx["tapped_calls"] >= 3
    assert ctx["correct"], ctx["checks"]
    assert ref_losses.crf is EXACT_CRF


# ---------------------------------------------- the span and the counters
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("landmarks"))
    out = make_synthetic_dataset(root, frame_hw=(48, 64), device="cpu")
    make_stand_in_cam_store(out["metadata_root"], root + "/cams")
    return root, out["metadata_root"]


CROP, BATCH = 24, 4


def _trainer(root, meta, outd, device, *flags):
    """The objects cli/train.main builds (TCAM, landmark CRF at M 64,
    fp32), on a one-block ResNet."""
    args, _ = parse_args([
        "--task", "TCAM", "--arch", "UnetTCAM", "--data_root", root,
        "--metadata_root", meta, "--std_cams_folder", root + "/cams",
        "--crop_size", str(CROP), "--resize_size", "28", "--batch_size",
        str(BATCH), "--eval_batch_size", "8", "--max_epochs", "1",
        "--cam_curve_interval", "0.05", "--freeze_cl", "true",
        "--sl_tc", "true", "--sl_tc_seed_tech", "seed_weighted",
        "--sl_tc_use_roi", "true", "--sl_tc_knn", "1", "--sl_tc_knn_mode",
        "before", "--crf_tc", "true", "--crf_impl", "landmarks",
        "--crf_n_landmarks", str(LANDMARKS), "--max_sizepos_tc", "true",
        "--compute_dtype", "float32", "--log_every", "0",
        "--checkpoint_save", "0", "--outd", outd, "--h2d_transfer", "uint8",
        "--train_device_cache_mb", "64",
        *flags])
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, device)
    mp = pytest.MonkeyPatch()
    mp.setattr(factory, "get_encoder",
               lambda name: resnet.ResNetWSOL(layers=(1, 1, 1, 1)))
    try:
        torch.manual_seed(0)
        model = factory.create_model_from_args(args, device=device)
    finally:
        mp.undo()
    return Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                   device=device)


def _epochs(root, meta, outd, device, chunk: int) -> list:
    TRACE.take()
    tr = _trainer(root, meta, outd, device, "--train_dispatch_chunk",
                  str(chunk))
    return [tr.train_epoch(0), tr.train_epoch(1)]


def _written_mb(steps: int) -> float:
    p = CROP * CROP
    return steps * 4 * BATCH * LANDMARKS * (p + LANDMARKS) / 1e6


def _assert_counts(rec) -> None:
    steps = rec["steps"]
    assert steps > 0
    assert rec["counts"]["crf.knm_builds"] == 2 * steps
    assert rec["counts"]["crf.knm_mb"] == pytest.approx(_written_mb(steps))
    assert rec["counts"]["crf.solve_failed"] == 0


@pytest.mark.parametrize("chunk", [0, 2], ids=["per_step", "chunked"])
def test_knm_builds_count_steps_on_the_eager_route(synth, tmp_path, chunk):
    recs = _epochs(*synth, str(tmp_path), torch.device("cpu"), chunk)
    for rec in recs:
        assert rec["dispatch"] == ("chunked" if chunk else "per_step")
        _assert_counts(rec)
        assert rec["spans"]["crf.landmarks"][0] == rec["steps"]


def test_a_failed_factorization_is_counted():
    a = torch.eye(8).repeat(3, 1, 1)
    a[1, 4, 4] = -1.0
    TRACE.take()
    from tcam_wsol_video_tpu_torch.ops import linalg
    linalg.batched_cholesky_solve(a, torch.ones((3, 8, 2)))
    assert TRACE.take()[1]["crf.solve_failed"] == 1


@pytest.mark.cuda
def test_graphs_count_as_the_eager_route_on_the_card(tmp_path):
    """K = 2 steps a CUDA graph against one step a dispatch, two epochs
    each of 3 steps (a graph of 2 and a tail of 1): every epoch counts 2
    builds a step and no failed factorization on both routes, and the
    graphs' span is recorded at their captures (and the eager warm-up of
    the first), not at their replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    root = str(tmp_path / "set")
    out = make_synthetic_dataset(root, frame_hw=(48, 64), device=device)
    make_stand_in_cam_store(out["metadata_root"], root + "/cams")
    eager = _epochs(root, out["metadata_root"], str(tmp_path / "e"),
                    device, 0)
    graphs = _epochs(root, out["metadata_root"], str(tmp_path / "g"),
                     device, 2)
    for e, g in zip(eager, graphs):
        assert (e["dispatch"], g["dispatch"]) == ("per_step", "chunked")
        assert e["steps"] == g["steps"] == 3
        _assert_counts(e)
        _assert_counts(g)
        assert e["spans"]["crf.landmarks"][0] == 3
    assert [g["spans"]["crf.landmarks"][0] for g in graphs] == [4, 3]
