"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --mesh-only    # path D, then path N alone
    python3 chip_smoke.py --visuals-only # path D, then paths O, P and
                                         # the import phase alone

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from the sources in this checkout (one nvcc
     per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes and a few edge shapes (for the exact filter, the
     edges of its tile-pair schedule too; for the Nystrom passes B = 1,
     ragged P and M, D = 3 and 8, K = 8), with the stated tolerances, and
     check that two launches of the exact filter, and two calls of each
     Nystrom pass, at batch 32 are bit-equal;
  3. path A, the stage-2 TCAM recipe of the end-to-end script (UnetTCAM
     on ResNet-50, 224 px, batch 32, exact dense CRF; fp32 weights, the
     JAX default dtype policy: bf16 train step, fp32 eval; random weights
     from SEED): STEPS train steps and one eval step, with launch counts
     reset just before; then the same STEPS steps from the same state at
     compute_dtype float32 (TF32 cuDNN convolutions);
  4. the same first step with every convolution in full fp32: its loss
     terms against the TF32 step's (the TF32 gap) and against the bf16
     step's (the bf16 gap); then path A's bf16 step from the same state
     with loss_chunk 8 and with remat against the plain step (losses,
     remat's parameter update and BN statistics), each one's peak memory
     and kernel 1's launches;
  5. at batch 2, the exact CRF loss value and gradient through the kernel
     against the same quantities from the plain version;
  6. path B, the production stage-2 recipe (landmark CRF, M = 1024, the
     build_knm kernel for K_nm and K_mm; compute_dtype float32, so that
     its kernel and solve numbers compare with earlier runs): STEPS train
     steps and one eval
     step; then the same first step from the same state through the fused
     Nystrom kernels (TCAM_FUSED_LANDMARKS=1, the lockstep solve between
     them), its loss terms against path B's; every cholesky_ex
     factorization checked (info == 0);
  7. path C, the eval step with the mean-field CRF refinement (5
     iterations of the exact kernel) at batch 32;
  8. at batch 2, the landmark CRF loss value and gradient through the
     kernels (both routes) against the plain versions;
  9. path D, the stage-2 trainer end to end through the CLI a user runs
     (cli/train.main with the stage-2 flags of the end-to-end script at
     bs 32 / 224 px, 2 epochs, random weights, the default dtype policy
     like paths E and F: bf16 train steps, fp32 eval, the convolutions'
     weight dtypes counted): a synthetic YTOv1-sized
     set written with nvJPEG, its round trip held against the source
     frames, a stand-in CAM store in place of stage 1; the data layer
     (nvJPEG decode on the card, CAM fusion and ROI on the host), the
     train step with the exact CRF kernel once per step, the ELB anneal,
     validation with the host box sweep (MaxBoxAcc), model selection and
     the test split at the best snapshots; launch counts reset just
     before;
 10. path E, the two-stage chain of the end-to-end script on path D's
     set, through the CLIs a user runs, launch counts reset just before:
     stage 1 (cli/train.main, STD_CL, bs 32 / 224 px, lr 0.001, 8 epochs,
     random weights), cli/dump_cams.main at its best-localization
     snapshot (past step 0; bf16; 640 CAMs and thresholds; the card's
     pixel route held against the source frames, one batch's CAMs at fp32
     against the CPU's and at bf16 against fp32), stage 2 with path D's flags from another seed over the dumped
     store, starting from stage 1's best-classification encoder and head
     (past step 0; its own weights checked unequal to them before the
     load and equal after; the exact CRF kernel once per step), and
     cli/evaluate.main at stage 2's
     best-localization snapshot against the trainer's own test pass;
 11. path F, stage 2 without a CAM store (cli/train.main with path D's
     flags, --sl_tc_use_roi false, 1 epoch) from path E's stage-1
     folder: each step recomputes the seed CAMs with the frozen
     classifier of its best-localization snapshot (past step 0); the
     seeder must get non-zero CAMs every step and the exact CRF kernel
     must launch once per step; launch counts reset just before;
 12. path G (run right after path D, on its set and store), the train
     data plane: cli/train.main with path D's flags plus --h2d_transfer
     uint8 --decode_cache_mb 256 --train_device_cache_mb 256 for 4
     epochs at --train_dispatch_chunk 0, launch counts reset just
     before: every epoch from the card-resident feed, each sampled frame
     decoded once, the exact CRF kernel once per step, libjpeg never
     loaded; then the feed's first epoch-1 batch against the streamed
     route (ids and uint8 pixels equal, the CAM side within JAX's
     tolerances); then path L: path G's data flags at JAX's default
     train_dispatch_chunk 8 for 2 epochs (each epoch's 5 steps one CUDA
     graph replay), then the same epochs from the same weights at 0:
     plans equal, the first step's and the epochs' losses within JAX's
     tolerances, kernel 1 once a step through the replays, each route's
     step, host enqueue, data wait and epoch wall; and the eval knobs on
     path L's snapshot (path D's test split decoded once and replayed:
     the counters bit-equal across eval_transfer, eval_sweep, pipeline
     depth and the device cache's two passes; images/s of each,
     on_device_eval's approximate MaxBoxAcc);
 13. roi_batch (ROI_LARGEST, ROI_H_DENSITY) at batch 32 / 224 px on the
     card against the host route roi_one_cam_np, timed;
 14. path H (on path D's set and store): cli/train.main with --config
     config_yaml/ytov1_stage2_tcam.yaml, the production script's
     --crf_impl landmarks, --im_rec true and --sl_tc_epoch_switch_to_sl 1,
     3 epochs: the seed source switches to the best student at epoch 1
     (reloaded only on a new best epoch; its roi_batch timed), build_knm
     twice a step;
 15. path I: the F_CL task (UnetFCAM, every F-CAM loss and im_rec, the
     exact CRF) through cli/train.main for 2 epochs, kernel 1 once a
     step, each loss term printed; then cli/evaluate.main on its
     best-localization snapshot against the trainer's test pass; then
     path M, the C_BOX task: cli/train.main with --config
     config_yaml/ytov1_cbox.yaml (DenseBoxNet on ResNet-50, bs 32 /
     224 px, every C_BOX loss, the 65 / 60 blur, 10 seeds, size_data
     priors) for 2 epochs over path E's dumped CAM store, its encoder and
     frozen classifier from path E's stage-1 folder, no kernel launched
     (no CRF); the valid-box share and loss terms per epoch; then
     cli/evaluate.main on its best-localization snapshot against the
     trainer's test pass; then the hold: a DenseBoxNet on path E's
     stage-1 encoder whose box head gives valid boxes, one C_BOX train
     step and one eval step on path M's first train batch on the card
     and on the CPU from the same state and injected noise (fp32, TF32
     off): the same valid boxes, every loss term live and within 1e-3,
     the box head's update within 1e-2 of its largest entry; and the
     step's Gaussian blur and one frozen-classifier forward timed apart
     with CUDA events at path M's dtype;
 16. path J (on path D's set): stage 1 (cli/train.main STD_CL, bs 32 /
     224 px, 1 epoch, the default dtypes) on VGG16/GAP,
     InceptionV3/WildCat (its SPG dropout live), ResNet-101/LSE and
     ResNet-50/MaxPool, no kernel launched; cli/evaluate.main on the
     ResNet-101 snapshot against the trainer's test pass; and
     cli/dump_cams.main from the VGG16/GAP snapshot (the built-in route,
     640 CAMs);
 17. path K: stage 2 (path D's flags, exact CRF) on VGG16 over path J's
     store, from its VGG16 folder, 1 epoch: the decoder's center block,
     kernel 1 once a step; then path A's step (2 steps, the first warms
     up) of UnetTCAM on InceptionV3 and on ResNet-101, kernel 1 once a
     step;
 18. the CAM-method phase: the stage-1 ResNet-50/WGAP model of path E's
     best-localization snapshot, the STD_CL eval step of each of its 9
     methods on path D's test frames, TF32 off, timed on the card (32
     images; ScoreCAM 2 images, SSCAM and ISCAM 1 image at 2 samples)
     and held against the same eval step on the CPU within 1e-3 (the
     first 8 images; the ScoreCAM family on the same frames at 32 px),
     the noise of SmoothGradCAM++ and SSCAM drawn once and injected;
 19. path N (on path D's set and store, after the CAM-method phase),
     several ranks: (a) cli/train.main under torch.distributed.run
     --nproc_per_node 1 (a world of 1 over NCCL) with path D's flags for
     1 epoch, its first-step loss and val counters before training
     against path D's, then cli/evaluate.main the same way; (b) 2 ranks
     (NCCL on two cards, or gloo on CUDA tensors when both share the one
     card) against one rank at path A's fp32 step (TF32 off, cuDNN
     deterministic, 16 frames a rank against 32, the seeder's noise each
     rank's rows of one global draw) for 2 steps: the losses, every
     parameter and the BN statistics within the bounds written in PERF.md
     before the run, the ranks' states bit-equal, kernel 1 once a step on
     each rank; each rank's step ms, gradient all-reduce ms and peak;
     (c) cli/evaluate.main on the 2 ranks over (a)'s snapshot: counters
     bit-equal to (a)'s world-1 evaluation;
 20. path O (after path N, on path D's set and its UnetTCAM ResNet-50
     best-localization snapshot): cli/demo_video.main on the card over
     the test-video-demo split (10 videos, 160 frames, eval bs 32) with
     --reuse_threshold 0 and at the median frame-to-frame mean |delta|
     of that run: the AVIs exist, hold each video's frames (chunks and
     idx1), frame 0 decoded by nvJPEG lies within DEMO_LUMA_PSNR_DB of
     its overlay array, every reused row's CAM is its video's last
     computed CAM, frames/s with and without reuse; then path D's trainer
     for 1 epoch with --plot_tr_cam_progress true and the final visual
     dump (every file JAX's hooks write, kernel 1 once a step); then
     cli/evaluate.main --multi_contour_eval false on path D's snapshot,
     its MaxBoxAcc and the host contour sweep's ms an image;
 21. path P: STD_CL ResNet-50/WGAP at crop 224, bs 32, on path D's
     frames laid out as image sets (2 frames a train shot, path D's val
     and test frames): 1 epoch and cli/evaluate.main as CUB; the PxAP
     route (cli/evaluate.main as OpenImages over PNG masks of the GT
     boxes written here); 1 epoch of ILSVRC's bucket loop over 2 buckets
     (16 chunk files), `true` as the stage and cleanup commands, every
     train id seen once; then the import phase: a torchvision-named
     ResNet-50 state dict, saved with torch.save, into the port's encoder
     on the card, its logits against the CPU's (TF32 off) within
     IMPORT_RTOL;
 22. the landmark filter's solve at path B's shapes: the lockstep solve
     against cholesky_ex, both timed, and the fused route (lockstep) at
     batch 32 against its plain version;
 23. time each kernel (and the exact filter's per-call spread and
     scratch), its plain version and its bound at the main paths' shapes,
     fail if a kernel reads under its bound, hold kernel and plain version
     together there, and print the kernel table.
The sources build first: one nvcc per CUDA source (the two kernel files
and the nvJPEG codec) and g++ for native/boxsweep.cpp, all started
together (and csrc/contours.cpp with g++ beside them).  The last line is
{"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.  There is no CPU fallback: without CUDA the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
STEPS = 3   # train steps on the main path; the first one warms up

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): fp32 on
# CUDA cores and HBM3 bandwidth.  The MUFU (ex2) rate is 16 per clock per
# SM against 128 fp32 FMA lanes, i.e. 16 / 256 of the fp32 flop rate.
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
MUFU_RATE = FP32_FLOPS * 16 / 256

# kernel vs plain: errors come from the norm-expansion cancellation in
# fp32 at |f|^2 ~ 2e2 and from ex2.approx (~2^-22 relative), summed over
# up to 5e4 terms; relative to the largest output value.
FILTER_RTOL = 2e-4
# the CRF loss and its gradient inherit the filter's relative error
CRF_RTOL = 2e-4
# a full-width step's loss terms, TF32 convolutions against full fp32:
# TF32 keeps 10 mantissa bits (~5e-4 relative per product)
TF32_RTOL = 1e-2
# the same against a bf16 step (bf16 activations and convolution inputs,
# fp32 BN statistics, losses cast to fp32 as in JAX): bf16 keeps 7
# mantissa bits (~4e-3 relative per rounding, 8x TF32's), and every
# activation is rounded, not only the products
BF16_RTOL = 5e-2
# K entries lie in [0, 1]: kernel and plain version differ by the fp32
# cancellation of the norm expansion (|f|^2 up to ~2.5e2, so ~1e-4
# absolute at most); in bf16 by one bf16 step at [0.5, 1) as well
KNM_ATOL = 1e-4
KNM_BF16_ATOL = 4e-3
# the Nystrom filter (fused kernels or the K_nm build route) against its
# plain version, relative to the largest output: the weights' fp32
# differences go through the ridge solve (K_mm + 1e-2 I); the landmark CRF
# loss and gradient inherit it
LMK_RTOL = 1e-3
# a full-width production step through the fused kernels against the
# build route from the same state: the same model, batch and seeder
# noise, only the filter's rounding differs
FUSED_RTOL = 1e-3
# a baseline JPEG at quality 95 with 4:2:0 chroma, decoded, against the
# frame it was encoded from: mean |difference| in levels per frame.  The
# synthetic frames are uniform noise in [0, 60) with a saturated square,
# so the subsampled chroma loses ~10 levels (libjpeg's round trip:
# 10.2-10.6, tests/test_torch_data.py holds it to the same bound)
JPEG_MEAN_ABS_TOL = 12.0

# path D: the synthetic set at YTOv1's 10 classes (160 train shots, 5
# steps of 32 an epoch; 320 val and 320 test frames), 2 epochs
PATH_D_DATA = dict(n_classes=10, n_videos_per_class=2, n_shots_per_video=8,
                   n_frames_per_shot=4, frame_hw=(270, 360))
PATH_D_EPOCHS = 2
# path E, the two-stage chain on the same set: stage 1 for 8 epochs, the
# fewest after which, from random weights at the stage-1 recipe's lr
# 0.001, validation picks both best snapshots past step 0 (on the card:
# classification leaves 10.00 only after epoch 6, localization passes the
# untrained weights' after epoch 5)
PATH_E_EPOCHS = 8
# one dump batch's CAMs, the card (TF32 cuDNN convolutions) against the
# CPU (fp32) on the same pixels and weights: min-max normalized maps in
# [0, 1], absolute; TF32's 10 mantissa bits (~5e-4 relative a product,
# path A's TF32 gap) through ~50 layers, then the normalization
CAM_TF32_ATOL = 2e-2
# the dump's CAMs at its default bf16 against fp32 on the card: bf16's
# rounding of every activation through ~50 layers (~1-2% of a feature),
# summed over 2048 channels and min-max normalized: a tenth of the range
CAM_BF16_ATOL = 1e-1


class Fail(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Fail(msg)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_call_ms(fn, reps: int, warmup: int = 1) -> list:
    """Device time of each of `reps` calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def spread(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "n": len(ms)}


# ------------------------------------------------------------ kernel checks
def filter_inputs(gen, b, h, w, sigma_xy, k=2):
    from tcam_wsol_video_tpu_torch.ops.crf import make_bilateral_features
    img = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
    feats = make_bilateral_features(img, 15.0, sigma_xy).contiguous()
    vals = torch.softmax(torch.randn((b, h * w, k), generator=gen,
                                     device="cuda"), -1).contiguous()
    return feats, vals


def compare_filter(name, feats, vals, single=False):
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    if single:
        got = bilateral.gaussian_filter_apply(feats[0], vals[0])[None]
    else:
        got = bilateral.gaussian_filter_apply_batched(feats, vals)
    torch.cuda.synchronize()
    want = bilateral.gaussian_filter_apply_plain(feats, vals)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale
    row = {"case": name, "shape": list(feats.shape) + [vals.shape[-1]],
           "max_abs_err": err, "max_rel_err": rel, "rtol": FILTER_RTOL}
    print(f"[check] {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
          f"rel={rel:.3e} (tol {FILTER_RTOL})", flush=True)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(rel <= FILTER_RTOL, f"{name}: kernel disagrees with plain "
          f"({rel:.3e} > {FILTER_RTOL})")
    return row


def phase_kernel_checks(seed: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [
        compare_filter("B2_224x224_D5_K2", *filter_inputs(gen, 2, 224, 224,
                                                          100.0)),
        compare_filter("B1_single_image_224x224",
                       *filter_inputs(gen, 1, 224, 224, 100.0), single=True),
        compare_filter("ragged_37x53_D5", *filter_inputs(gen, 3, 37, 53,
                                                         100.0)),
        compare_filter("color_only_224x224_D3",
                       *filter_inputs(gen, 2, 224, 224, None)),
    ]
    f, v = filter_inputs(gen, 2, 37, 53, None, k=1)
    rows.append(compare_filter("padded_D2_K1", f[..., :2].contiguous(), v))
    # the pair schedule's edges (tiles of 256 pixels): P under one tile,
    # one tile, odd and even tile counts, B = 1 with split strips, K = 8
    for name, b, h, w, sxy, k in (
            ("P117_below_tile", 2, 9, 13, 100.0, 2),
            ("P256_one_tile", 2, 16, 16, 100.0, 2),
            ("odd_3_tiles", 2, 25, 28, 100.0, 2),
            ("even_4_tiles_D3", 2, 30, 30, None, 2),
            ("B1_36_tiles_split", 1, 96, 96, 100.0, 2),
            ("B1_13_tiles_K5", 1, 56, 56, 100.0, 5)):
        rows.append(compare_filter(name, *filter_inputs(gen, b, h, w, sxy,
                                                        k=k)))
    return rows


def check_bit_equal(seed: int, b: int = 32, crop: int = 224) -> dict:
    """Two launches on the same inputs at the main path's shape give
    bit-equal results (no atomics; fixed-order reduction)."""
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    feats, vals = filter_inputs(gen, b, crop, crop, 100.0)
    first = bilateral.gaussian_filter_apply_batched(feats, vals)
    second = bilateral.gaussian_filter_apply_batched(feats, vals)
    same = bool(torch.equal(first, second))
    print(f"[check] bilateral B={b} {crop}x{crop}: two launches bit-equal "
          f"{same}", flush=True)
    check(same, "bilateral kernel: two launches on the same inputs differ")
    return {"case": f"B{b}_{crop}x{crop}_two_launches", "bit_equal": same}


def landmark_inputs(gen, b, h, w, sigma_xy, m_req, k=2, extra_d=0):
    """Centred features (extra_d standard normal columns after the
    bilateral ones), landmark features and indices, values."""
    from tcam_wsol_video_tpu_torch.ops.crf import _landmark_grid_indices
    feats, vals = filter_inputs(gen, b, h, w, sigma_xy, k)
    if extra_d:
        feats = torch.cat([feats, torch.randn(
            (b, h * w, extra_d), generator=gen, device="cuda")], -1)
    feats = (feats - feats.mean(1, keepdim=True)).contiguous()
    idx = torch.from_numpy(_landmark_grid_indices(h, w, m_req)).cuda()
    return feats, feats[:, idx].contiguous(), idx, vals


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| one image at a time (K_nm is 6.6 GB at batch 32)."""
    return max((a[i].float() - b[i].float()).abs().max().item()
               for i in range(a.shape[0]))


def compare_knm(name, feats, fm, out_dtype=torch.float32, want=None):
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    got = landmarks.build_knm(feats, fm, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if want is None:
        want = landmarks.build_knm_plain(feats, fm)
    err = max_abs_diff(got, want)
    tol = KNM_ATOL if out_dtype == torch.float32 else KNM_BF16_ATOL
    row = {"case": name, "kernel": "knm_build",
           "shape": list(feats.shape) + [fm.shape[1]],
           "dtype": str(out_dtype), "max_abs_err": err, "atol": tol}
    print(f"[check] knm_build {name} {str(out_dtype)[6:]}: "
          f"max_abs_err={err:.3e} (atol {tol})", flush=True)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite K")
    check(err <= tol, f"knm_build {name}: kernel disagrees with plain "
          f"({err:.3e} > {tol})")
    return row


def _rel_row(kernel, name, got, want, shape, rtol):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale
    print(f"[check] {kernel} {name}: max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} rel={rel:.3e} (tol {rtol})", flush=True)
    check(bool(torch.isfinite(got).all()), f"{kernel} {name}: non-finite")
    check(rel <= rtol, f"{kernel} {name}: kernel disagrees with plain "
          f"({rel:.3e} > {rtol})")
    return {"case": name, "kernel": kernel, "shape": shape,
            "max_abs_err": err, "max_rel_err": rel, "rtol": rtol}


def compare_nystrom(name, feats, fm, idx, vals, routes=True):
    """Pass 1 against its plain version, pass 2 against its plain version
    on the plain solve's alpha, the fused filter and (routes) the whole
    landmark filter on both routes against nystrom_filter_plain."""
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    shape = list(feats.shape) + [fm.shape[1], vals.shape[2]]
    with linalg.record_info() as infos:
        rhs = landmarks.nystrom_rhs(feats, fm, vals)
        want_rhs = landmarks.nystrom_rhs_plain(feats, fm, vals)
        kmm = landmarks.add_ridge(landmarks.build_knm_plain(fm, fm), 1e-2)
        alpha = linalg.batched_cholesky_solve(kmm, want_rhs)
        out = landmarks.nystrom_out(feats, fm, alpha)
        fused = landmarks.nystrom_filter(feats, vals, idx)
        api = {}
        if routes:
            for route in ("fused", "build_route"):
                api[route] = crf.gaussian_filter_apply_landmarks(
                    feats, vals, idx, fused=route == "fused")
        torch.cuda.synchronize()
        want = landmarks.nystrom_filter_plain(feats, vals, idx)
    check(all(int(i.abs().max()) == 0 for i in infos),
          f"{name}: a Cholesky factorization failed")
    rows = [_rel_row("nystrom_rhs", name, rhs, want_rhs, shape, FILTER_RTOL),
            _rel_row("nystrom_out", name, out,
                     landmarks.nystrom_out_plain(feats, fm, alpha), shape,
                     LMK_RTOL),
            _rel_row("nystrom_filter_fused", name, fused, want, shape,
                     LMK_RTOL)]
    rows += [_rel_row(f"landmark_filter_{route}", name, got, want, shape,
                      LMK_RTOL) for route, got in api.items()]
    return rows


def phase_landmark_checks(seed: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    rows = []
    cases = [("B2_224x224_D5_M1024", 2, 224, 224, 100.0, 1024),
             ("ragged_37x53_D5_M512", 3, 37, 53, 100.0, 512),
             ("color_only_224x448_D3_M1024", 2, 224, 448, None, 1024)]
    for name, b, h, w, sxy, m_req in cases:
        feats, fm, idx, vals = landmark_inputs(gen, b, h, w, sxy, m_req)
        print(f"[landmarks] {name}: P={h * w} M={fm.shape[1]} "
              f"D={feats.shape[2]}", flush=True)
        rows.append(compare_knm(name, feats, fm))
        if name.startswith("B2_224"):
            rows.append(compare_knm(name, feats, fm, torch.bfloat16))
        rows.append(compare_knm(name + "_Kmm", fm, fm))
        rows += compare_nystrom(name, feats, fm, idx, vals)
    # the Nystrom passes' edges: B = 1, P and M off the 8-key and 16-row
    # tiles, D = 3 and 8 (two k = 8 steps), K = 8 (and K = 5 padded to 8)
    for name, b, h, w, sxy, m_req, k, extra_d in (
            ("B1_29x31_D5_M128", 1, 29, 31, 100.0, 128, 2, 0),
            ("B1_9x13_D3_M40", 1, 9, 13, None, 40, 2, 0),
            ("K8_40x40_D5_M256", 2, 40, 40, 100.0, 256, 8, 0),
            ("K5_37x41_D5_M200", 2, 37, 41, 100.0, 200, 5, 0),
            ("D8_48x48_M300", 2, 48, 48, 100.0, 300, 2, 3),
            ("D8_K8_B1_33x35_M150", 1, 33, 35, 100.0, 150, 8, 3)):
        feats, fm, idx, vals = landmark_inputs(gen, b, h, w, sxy, m_req, k,
                                               extra_d)
        print(f"[landmarks] {name}: P={h * w} M={fm.shape[1]} "
              f"D={feats.shape[2]} K={k}", flush=True)
        rows += compare_nystrom(name, feats, fm, idx, vals, routes=False)
    return rows


def check_nystrom_bit_equal(seed: int, b: int = 32, crop: int = 224,
                            m_req: int = 1024) -> dict:
    """Two calls of each Nystrom pass on the same inputs at path B's shape
    give bit-equal results (no atomics; pass 1's slices added in a fixed
    order)."""
    from tcam_wsol_video_tpu_torch.ops import linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    feats, fm, _, vals = landmark_inputs(gen, b, crop, crop, 100.0, m_req)
    rhs = [landmarks.nystrom_rhs(feats, fm, vals) for _ in range(2)]
    kmm = landmarks.add_ridge(landmarks.build_knm(fm, fm), 1e-2)
    alpha = linalg.batched_cholesky_solve(kmm, rhs[0])
    out = [landmarks.nystrom_out(feats, fm, alpha) for _ in range(2)]
    same = {"nystrom_rhs": bool(torch.equal(*rhs)),
            "nystrom_out": bool(torch.equal(*out))}
    print(f"[check] Nystrom passes B={b} {crop}x{crop} M={fm.shape[1]}: two "
          f"calls bit-equal {same}", flush=True)
    check(all(same.values()), f"Nystrom passes: two calls differ {same}")
    del feats, fm, vals, rhs, kmm, alpha, out
    torch.cuda.empty_cache()
    return {"case": f"B{b}_{crop}x{crop}_M{m_req}_two_calls", **same}


# --------------------------------------------------------------- main path
def synthetic_batch(rng: np.random.Generator, args) -> dict:
    """Host batch as the JAX dataset builds it (data/dataset.py get_one):
    normalized image, raw image, stored CAM and its Otsu ROI (the port's
    host ROI code).  Frames are smooth color fields with one elliptic
    object; the CAM is a blob on the object."""
    from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
    from tcam_wsol_video_tpu_torch.core import constants
    b, crop = args.batch_size, args.crop_size
    yy, xx = np.mgrid[0:crop, 0:crop].astype(np.float32) / crop
    raw = np.empty((b, crop, crop, 3), np.float32)
    cams = np.empty((b, crop, crop), np.float32)
    rois = np.empty((b, crop, crop), np.int32)
    msk = np.empty((b, crop, crop), np.float32)
    for i in range(b):
        base = rng.random(3) * 255.0
        grad = (rng.random(3) - 0.5) * 120.0
        img = base + grad * (xx[..., None] + yy[..., None]) / 2.0
        cy, cx = rng.uniform(0.3, 0.7, 2)
        ry, rx = rng.uniform(0.1, 0.25, 2)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[inside] = rng.random(3) * 255.0
        img += rng.normal(0.0, 8.0, img.shape)
        raw[i] = np.clip(img, 0.0, 255.0)
        cam = np.exp(-(((yy - cy) / (1.5 * ry)) ** 2
                       + ((xx - cx) / (1.5 * rx)) ** 2))
        cams[i] = np.clip(cam + rng.normal(0.0, 0.02, cam.shape), 0.0, 1.0)
        roi, m, _ = roi_one_cam_np(cams[i], args.sl_tc_roi_method,
                                   args.sl_tc_roi_min_size)
        rois[i], msk[i] = roi, m
    mean = np.asarray(constants.IMAGENET_MEAN, np.float32) * 255.0
    std = np.asarray(constants.IMAGENET_STD, np.float32) * 255.0
    return {
        "image": (raw - mean) / std,
        "raw_img": raw,
        "label": rng.integers(0, args.num_classes, b).astype(np.int64),
        "std_cam": cams,
        "roi": rois,
        "msk_bbox": msk,
    }


class CrfTimer:
    """Times every call of module.<attr> (the CRF filter the path runs)
    with CUDA events."""

    def __init__(self, module, attr="gaussian_filter_apply_batched"):
        self.module = module
        self.attr = attr
        self.orig = getattr(module, attr)
        self.pairs = []

    def __enter__(self):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.orig(*a, **kw)
            e1.record()
            self.pairs.append((e0, e1))
            return out
        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)

    def take_ms(self) -> float:
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return ms


def build_main_path(seed: int, production: bool = False,
                    dtype: str = "bfloat16", encoder: str = "resnet50",
                    mesh=None):
    """The recipe's model (on `encoder`), optimizer, steps, batch and
    seeder generator (production: the production stage-2 recipe, landmark
    CRF) at compute_dtype `dtype`, the train step a rank's of `mesh` when
    given; two builds from one seed start from the same state."""
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import (
        stage2_tcam_production, stage2_tcam_recipe)
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import (make_cam_eval_step,
                                                        make_train_step)
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args

    args = (stage2_tcam_production if production
            else stage2_tcam_recipe)(seed=seed, compute_dtype=dtype,
                                     encoder_name=encoder)
    kc = KeyChain(seed)
    torch.manual_seed(seed)
    model = create_model_from_args(args, device="cuda")
    opt = build_optimizer(args, model, args.lr)
    state = TrainState(model, opt, elb_t=args.elb_init_t)
    master = get_loss_tcam(args)
    train_step = make_train_step(master, args, seeder_cfg_from_args(args),
                                 mesh=mesh)
    eval_step = make_cam_eval_step(model, args)
    host = synthetic_batch(kc.numpy_rng("chip_smoke", "batch"), args)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gen = kc.key("chip_smoke", "seeder", device="cuda")
    return (args, model, opt, state, train_step, eval_step, batch, gen,
            master.switches(0))


def phase_main_path(seed: int, steps: int, profile: bool,
                    dtype: str) -> dict:
    """Path A at compute_dtype `dtype` (eval at float32)."""
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

    (args, model, opt, state, train_step, eval_step, batch, gen,
     switches) = build_main_path(seed, dtype=dtype)
    tag = f"path A {dtype}"
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    records = []
    with CrfTimer(bilateral) as crf_timer:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = train_step(state, batch, switches, seed_weighted=True,
                             generator=gen)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            rec = {k: float(v) for k, v in met.items()}
            rec["step_ms"] = step_ms
            rec["crf_kernel_ms"] = crf_timer.take_ms()
            records.append(rec)
            print(f"[{tag}] step {i}: " + " ".join(
                f"{k}={v:.6g}" for k, v in rec.items()), flush=True)
            for k, v in rec.items():
                check(np.isfinite(v), f"step {i}: {k} is not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cams, logits = eval_step(batch["image"])
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {"kernel": bilateral.counts.kernel,
                "plain": bilateral.counts.plain}
    check(all(c["plain"] == 0 for c in read_counts().values()),
          f"{tag}: a plain version ran")
    print(f"[{tag} eval] cams {tuple(cams.shape)} logits {tuple(logits.shape)} "
          f"{eval_ms:.2f} ms; cam range [{cams.min().item():.4f}, "
          f"{cams.max().item():.4f}]", flush=True)
    print(f"[{tag} launches] bilateral kernel={launches['kernel']} "
          f"plain={launches['plain']}", flush=True)
    crop = args.crop_size
    check(tuple(cams.shape) == (args.batch_size, crop, crop),
          f"eval cams shape {tuple(cams.shape)}")
    check(tuple(logits.shape) == (args.batch_size, args.num_classes),
          f"eval logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(cams).all()) and cams.min().item() >= 0.0
          and cams.max().item() <= 1.0, "eval cams outside [0, 1]")
    check(bool(torch.isfinite(logits).all()), "eval logits not finite")
    check(launches["kernel"] == steps, f"{tag}: the CRF kernel launched "
          f"{launches['kernel']} times in {steps} steps")
    check(launches["plain"] == 0, f"{tag}: the plain filter ran")

    n_params = sum(p.numel() for p in model.parameters())
    n_frozen = sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith(("encoder.", "classification_head.")))
    print(f"[{tag} model] {n_params} parameters, {n_frozen} of them frozen "
          f"(encoder + head under freeze_cl)", flush=True)
    after = records[1:] if len(records) > 1 else records
    out = {"dtype": dtype, "steps": records, "eval_ms": eval_ms,
           "launches": launches,
           "params": n_params, "frozen_params": n_frozen,
           "median_step_ms": statistics.median(r["step_ms"] for r in after),
           "median_crf_kernel_ms": statistics.median(
               r["crf_kernel_ms"] for r in after),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        out["profile"] = profile_step(train_step, state, batch, switches,
                                      gen, tag)
    del state, model, opt, batch
    torch.cuda.empty_cache()
    return out


def profile_step(train_step, state, batch, switches, gen, tag) -> dict:
    """Kernel time by name over one train step (torch.profiler), and the
    device's idle share of that step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, switches, seed_weighted=True,
                   generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: operator rows repeat their kernels' device time,
    # and user annotations (Optimizer.step, ...) span kernels
    rows = [{"name": ev.key, "device_ms": ev.self_device_time_total / 1e3,
             "calls": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    idle = max(0.0, 1.0 - total / wall_ms)
    groups = group_kernel_time(rows)
    print(f"[profile {tag}] kernel time {total:.2f} ms in a {wall_ms:.2f} ms "
          f"step under the profiler (device idle {100 * idle:.1f}%); by "
          f"group: " + "; ".join(f"{g} {ms:.2f}" for g, ms in groups.items())
          + "; top:", flush=True)
    for r in rows[:12]:
        print(f"[profile {tag}]   {r['device_ms']:9.3f} ms  x{r['calls']:<4d}"
              f" {r['name'][:90]}", flush=True)
    return {"kernel_ms": total, "wall_ms": wall_ms, "idle_share": idle,
            "groups": groups, "rows": rows}


# kernel-name patterns of the profile's groups, first match wins (BN
# before the convolutions: cuDNN's BN kernels are cudnn:: too; the
# convolutions before the GEMMs: cuDNN's implicit GEMMs say gemm)
KERNEL_GROUPS = (
    ("exact CRF", ("bilateral",)),
    ("landmark kernels", ("knm", "nystrom")),
    ("Cholesky solve", ("magma", "potrf", "potf2", "trsm", "trsv", "syrk",
                        "herk", "chol")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolutions", ("fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "conv", "cudnn")),
    ("GEMMs", ("gemm", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("transposes and copies", ("transpose", "copy", "permute", "nchw",
                               "nhwc")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "index", "scatter", "gather", "cat",
                                    "fill", "where", "sum", "norm")),
)


def group_kernel_time(rows) -> dict:
    """Device ms by KERNEL_GROUPS group (case-insensitive substrings), the
    unmatched kernels under "rest"."""
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["rest"] = 0.0
    for r in rows:
        name = r["name"].lower()
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in name for k in keys)), "rest")
        groups[g] += r["device_ms"]
    return groups


# ---------------------------------------------------- path B: production
@contextlib.contextmanager
def fused_landmarks(on: bool):
    """TCAM_FUSED_LANDMARKS for the block (the landmark filter reads it)."""
    old = os.environ.get("TCAM_FUSED_LANDMARKS")
    os.environ["TCAM_FUSED_LANDMARKS"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["TCAM_FUSED_LANDMARKS"]
        else:
            os.environ["TCAM_FUSED_LANDMARKS"] = old


def reset_counts() -> None:
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, landmarks
    for c in (bilateral.counts, landmarks.knm_counts, landmarks.rhs_counts,
              landmarks.out_counts):
        c.reset()


def read_counts() -> dict:
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, landmarks
    return {name: {"kernel": c.kernel, "plain": c.plain} for name, c in (
        ("bilateral_exact", bilateral.counts),
        ("knm_build", landmarks.knm_counts),
        ("nystrom_rhs", landmarks.rhs_counts),
        ("nystrom_out", landmarks.out_counts))}


def run_steps(train_step, state, batch, switches, gen, steps, timer,
              tag) -> list:
    records = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(state, batch, switches, seed_weighted=True,
                         generator=gen)
        torch.cuda.synchronize()
        rec = {k: float(v) for k, v in met.items()}
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        rec["crf_ms"] = timer.take_ms()
        records.append(rec)
        print(f"[{tag}] step {i}: " + " ".join(
            f"{k}={v:.6g}" for k, v in rec.items()), flush=True)
        for k, v in rec.items():
            check(np.isfinite(v), f"{tag} step {i}: {k} is not finite")
    return records


def check_infos(infos, tag) -> int:
    check(len(infos) > 0, f"{tag}: no Cholesky solve ran")
    bad = sum(int(i.abs().max()) != 0 for i in infos)
    check(bad == 0, f"{tag}: {bad} Cholesky factorizations failed")
    return len(infos)


def phase_production(seed: int, steps: int, profile: bool) -> dict:
    """Path B (build route) at compute_dtype float32, then its first step
    on the fused route; with `profile`, one step of each profiled, and a
    build-route step at bf16 too."""
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    (args, model, _, state, train_step, eval_step, batch, gen,
     switches) = build_main_path(seed, production=True, dtype="float32")
    print(f"[path B] crf_impl={args.crf_impl} M={args.crf_n_landmarks} "
          f"seeds {args.sl_tc_min}/{args.sl_tc_max} ksz {args.sl_tc_ksz}",
          flush=True)
    with fused_landmarks(False), linalg.record_info() as infos, \
            CrfTimer(crf, "gaussian_filter_apply_landmarks") as timer:
        reset_counts()
        records = run_steps(train_step, state, batch, switches, gen, steps,
                            timer, "path B")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cams, logits = eval_step(batch["image"])
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
    n_solves = check_infos(infos, "path B")
    print(f"[path B] launches {launches}; {n_solves} Cholesky solves, "
          f"info all 0; eval {eval_ms:.2f} ms", flush=True)
    check(launches["knm_build"]["kernel"] >= 2 * steps,
          f"path B: build_knm launched {launches['knm_build']['kernel']} "
          f"times in {steps} steps (K_nm + K_mm each)")
    check(launches["nystrom_rhs"]["kernel"] == 0
          and launches["nystrom_out"]["kernel"] == 0,
          "path B: the fused kernels ran on the build route")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path B: a plain version ran")
    check(tuple(cams.shape) == (args.batch_size, args.crop_size,
                                args.crop_size)
          and bool(torch.isfinite(cams).all()) and cams.min() >= 0
          and cams.max() <= 1, "path B: eval cams wrong")
    after = records[1:] if len(records) > 1 else records
    out = {"steps": records, "eval_ms": eval_ms, "launches": launches,
           "cholesky_solves": n_solves,
           "median_step_ms": statistics.median(r["step_ms"] for r in after),
           "median_crf_ms": statistics.median(r["crf_ms"] for r in after),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        with fused_landmarks(False):
            out["profile"] = profile_step(train_step, state, batch,
                                          switches, gen, "path B float32")
    del state, model, batch
    torch.cuda.empty_cache()
    if profile:
        out["profile_bf16"] = profile_production_bf16(seed)

    # the same first step from the same state through the fused kernels
    (_, model, _, state, train_step, _, batch, gen,
     switches) = build_main_path(seed, production=True, dtype="float32")
    with fused_landmarks(True), linalg.record_info() as infos, \
            CrfTimer(crf, "gaussian_filter_apply_landmarks") as timer:
        reset_counts()
        fused = run_steps(train_step, state, batch, switches, gen, steps,
                          timer, "path B fused")
        fused_launches = read_counts()
    check(len(infos) == 0, "path B fused: cholesky_ex ran; the fused "
          "route solves with the lockstep solve")
    print(f"[path B fused] launches {fused_launches} (lockstep solve)",
          flush=True)
    check(fused_launches["nystrom_rhs"]["kernel"] >= 1
          and fused_launches["nystrom_out"]["kernel"] >= 1,
          "path B fused: the Nystrom kernels did not run")
    check(all(c["plain"] == 0 for c in fused_launches.values()),
          "path B fused: a plain version ran")
    gap = {}
    for k, v in fused[0].items():
        if k in ("step_ms", "crf_ms", "n", "n_correct"):
            continue
        ref = records[0][k]
        gap[k] = abs(v - ref) / max(abs(ref), 1e-30)
        print(f"[path B fused] step 0 {k}: fused={v:.8e} build={ref:.8e} "
              f"rel={gap[k]:.3e} (tol {FUSED_RTOL})", flush=True)
    for k, rel in gap.items():
        check(rel <= FUSED_RTOL, f"fused step 0 {k} is {rel:.3e} off the "
              f"build route")
    out["fused"] = {"steps": fused, "launches": fused_launches,
                    "rel_gap": gap, "rtol": FUSED_RTOL}
    fused_after = fused[1:] if len(fused) > 1 else fused
    out["fused_step_ms"] = statistics.median(r["step_ms"]
                                             for r in fused_after)
    out["fused_crf_ms"] = statistics.median(r["crf_ms"] for r in fused_after)
    if profile:
        with fused_landmarks(True):
            out["fused"]["profile"] = profile_step(
                train_step, state, batch, switches, gen,
                "path B fused float32")
    # path C on this model: eval with the mean-field CRF refinement
    out["path_c"] = phase_post_process(args, model, batch)
    del state, model, batch
    torch.cuda.empty_cache()
    return out


def profile_production_bf16(seed: int) -> dict:
    """One profiled build-route step of path B at compute_dtype bfloat16,
    after two unprofiled ones."""
    from tcam_wsol_video_tpu_torch.ops import crf
    (_, model, _, state, train_step, _, batch, gen,
     switches) = build_main_path(seed, production=True, dtype="bfloat16")
    with fused_landmarks(False), CrfTimer(
            crf, "gaussian_filter_apply_landmarks") as timer:
        run_steps(train_step, state, batch, switches, gen, 2, timer,
                  "path B bfloat16")
        prof = profile_step(train_step, state, batch, switches, gen,
                            "path B bfloat16")
    del state, model, batch
    torch.cuda.empty_cache()
    return prof


def phase_post_process(args, model, batch) -> dict:
    """Path C: the eval step with crf_post_process (mean-field, exact
    bilateral kernel twice per iteration)."""
    from tcam_wsol_video_tpu_torch.engine.steps import make_cam_eval_step
    args = args.replace(crf_post_process=True)
    eval_step = make_cam_eval_step(model, args)
    eval_step(batch["image"][:2], batch["raw_img"][:2])   # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    cams, logits = eval_step(batch["image"], batch["raw_img"])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    print(f"[path C] eval + {args.crf_pp_iters} mean-field iterations: "
          f"{eval_ms:.2f} ms; cams {tuple(cams.shape)} range "
          f"[{cams.min().item():.4f}, {cams.max().item():.4f}]; launches "
          f"{launches}", flush=True)
    check(launches["bilateral_exact"]["kernel"] >= 2 * args.crf_pp_iters,
          "path C: the exact kernel ran "
          f"{launches['bilateral_exact']['kernel']} times")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path C: a plain version ran")
    check(tuple(cams.shape) == (args.batch_size, args.crop_size,
                                args.crop_size)
          and bool(torch.isfinite(cams).all()) and cams.min() >= 0
          and cams.max() <= 1, "path C: cams outside [0, 1]")
    return {"eval_ms": eval_ms, "launches": launches,
            "iters": args.crf_pp_iters}


# ------------------------------------------------ path D: the trainer
def common_flags(root: str, seed: int = SEED) -> list:
    """COMMON of cmds/e2e_synth224_tpu.sh on the synthetic set at root,
    with the seed and the card."""
    return [
        "--dataset", "YouTube-Objects-v1.0", "--data_root", root,
        "--metadata_root", os.path.join(root, "folds"), "--crop_size", "224",
        "--resize_size", "256", "--cam_curve_interval", "0.01",
        "--num_workers", "4", "--seed", str(seed), "--log_every", "0",
        "--device", "cuda"]


def path_d_flags(root: str, store: str, outd: str, pretrained: str = "",
                 seed: int = SEED, epochs: int = PATH_D_EPOCHS,
                 use_roi: bool = True, exp_id: str = "s2") -> list:
    """The stage-2 command of cmds/e2e_synth224_tpu.sh (freeze_cl from
    config_yaml/ytov1_stage2_tcam.yaml), `epochs` epochs, random weights
    from `seed`, over the CAM store `store` (none when empty: the seed
    CAMs are then recomputed from the stage-1 folder's classifier) and the
    stage-1 folder `pretrained`, when given; no rolling checkpoints."""
    return common_flags(root, seed) + [
        "--task", "TCAM", "--arch", "UnetTCAM",
        "--batch_size", "32", "--eval_batch_size", "32",
        "--max_epochs", str(epochs), "--lr", "0.01",
        "--freeze_cl", "True",
        "--elb_init_t", "1.0", "--elb_max_t", "10.0", "--elb_mulcoef",
        "1.01", "--sl_tc", "True", "--sl_tc_lambda", "1.0", "--sl_tc_min",
        "1", "--sl_tc_max", "1", "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6",
        "--sl_tc_min_p", "0.1", "--sl_tc_seed_tech", "seed_weighted",
        "--sl_tc_use_roi", str(use_roi), "--sl_tc_roi_method", "roi_all",
        "--sl_tc_roi_min_size", "0.05", "--sl_tc_knn", "1",
        "--sl_tc_knn_mode", "before", "--sl_tc_knn_t", "0.0",
        "--crf_tc", "True", "--crf_tc_lambda", "2e-9",
        "--crf_tc_sigma_rgb", "15.0", "--crf_tc_sigma_xy", "100.0",
        "--crf_tc_scale", "1.0", "--max_sizepos_tc", "True",
        "--max_sizepos_tc_lambda", "0.01", "--checkpoint_save", "0",
        "--outd", outd, "--exp_id", exp_id] + (
            ["--std_cams_folder", store] if store else []) + (
            ["--folder_pre_trained_cl", pretrained] if pretrained else [])


def path_e_stage1_flags(root: str, outd: str) -> list:
    """The stage-1 command of cmds/e2e_synth224_tpu.sh with the batch and
    learning rate of config_yaml/ytov1_stage1_cam.yaml (32, 0.001),
    PATH_E_EPOCHS epochs, random weights, no rolling checkpoints."""
    return common_flags(root) + [
        "--task", "STD_CL", "--batch_size", "32", "--eval_batch_size", "32",
        "--max_epochs", str(PATH_E_EPOCHS), "--lr", "0.001",
        "--checkpoint_save", "0", "--outd", outd, "--exp_id", "s1"]


def _eval_line(tag: str, r: dict) -> str:
    return (f"[{tag}] {r['n_images']} images, {r['images_per_s']:.1f} "
            f"images/s, forward {r['forward_ms_per_batch']:.2f} ms/batch, "
            f"native sweep {r['sweep_ms_per_image']:.3f} ms/image; "
            f"classification {r['classification']:.2f}, MaxBoxAcc "
            f"30/50/70 {r['maxboxacc_30']:.2f}/{r['maxboxacc_50']:.2f}/"
            f"{r['maxboxacc_70']:.2f}")


def make_trainer_set(seed: int) -> dict:
    """The YTOv1-sized synthetic set of paths D and E, written with nvJPEG
    under build/, and its JPEG round trip against the source frames."""
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.synthetic import \
        make_synthetic_dataset

    root = os.path.join(ROOT, "build", "chip_smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    synth = make_synthetic_dataset(root, seed=seed, device="cuda",
                                   keep_frames=32, **PATH_D_DATA)
    gen_s = time.perf_counter() - t0
    errs = []
    for fid, src in synth["frames"].items():
        dec = nvjpeg_loader.decode(os.path.join(synth["data_root"], fid))
        errs.append(float(np.abs(dec.cpu().numpy().astype(np.float64)
                                 - src).mean()))
    print(f"[data] synthetic set {PATH_D_DATA} written in {gen_s:.2f} s "
          f"(nvJPEG, quality 95); round trip of {len(errs)} frames: mean "
          f"|decoded - source| median {statistics.median(errs):.3f}, max "
          f"{max(errs):.3f} levels (tol {JPEG_MEAN_ABS_TOL})", flush=True)
    check(max(errs) <= JPEG_MEAN_ABS_TOL,
          f"nvJPEG round trip is {max(errs):.3f} levels off the source")
    return {"root": root, "synth": synth, "gen_s": gen_s,
            "jpeg_round_trip_mean_abs": errs}


def report_trainer(tag: str, out: dict, epochs: int) -> dict:
    """Checks and prints a cli/train.main run of `epochs` epochs of 5 steps
    on the synthetic set: per epoch the step, data wait, loss and ELB t;
    per eval pass its throughput, classification and MaxBoxAcc (320
    images); the test pass at the best-localization snapshot.  Returns
    {'steps', 'best'}."""
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.losses.elb import update_t

    train = out["records"]["train"]
    evals = out["records"]["eval"]
    print(f"[{tag}] compute_dtype {out['args'].compute_dtype}, "
          f"eval_compute_dtype {out['args'].eval_compute_dtype}", flush=True)
    check(len(train) == epochs and all(r["steps"] == 5 for r in train),
          f"{tag}: steps per epoch {[r['steps'] for r in train]}, not 5")
    t = 1.0
    for r in train:
        t = update_t(t, 1.01, 10.0)
        print(f"[{tag} epoch {r['epoch']}] wall {r['wall_ms']:.1f} ms, "
              f"{r['steps']} steps, median step {r['median_step_ms']:.2f} "
              f"ms (CUDA events), data wait {r['data_wait_ms_per_step']:.2f}"
              f" ms/step (pixels {r['data_pixels_ms_per_step']:.2f}, CAM "
              f"side {r['data_cams_ms_per_step']:.2f}); loss "
              f"{r['loss']:.6g}; ELB t after the epoch "
              f"{r['elb_t']:.6f}; the steps' spans cover "
              f"{100 * sum(r['step_ms']) / r['wall_ms']:.1f}% of the epoch",
              flush=True)
        check(np.isfinite(r["loss"]), f"{tag} epoch {r['epoch']}: loss")
        check(r["elb_t"] == t, f"{tag}: ELB t {r['elb_t']} after epoch "
              f"{r['epoch']}, expected {t}")
    for i, e in enumerate(evals):
        when = (e["snapshot"] if e["snapshot"] else "before training"
                if i == 0 else f"after epoch {e['epoch']}")
        print(_eval_line(f"{tag} eval {e['split']} {when}", e), flush=True)
        check(e["n_images"] == 320, f"{tag}: {e['n_images']} images in "
              f"{e['split']}")
        check(all(0.0 <= e[f"maxboxacc_{s}"] <= 100.0 for s in (30, 50, 70)),
              f"{tag}: MaxBoxAcc outside [0, 100]")
    check(constants.BEST_LOC in out["test"], f"{tag}: no test evaluation "
          "at the best-localization snapshot")
    best = out["test"][constants.BEST_LOC]
    print(_eval_line(f"{tag} test best_localization",
                     {**best, **best["timing"]}), flush=True)
    return {"steps": sum(r["steps"] for r in train),
            "best": {k: v for k, v in best.items() if k != "curves"}}


def phase_trainer(seed: int, data: dict) -> dict:
    """Path D: the stand-in CAM store, then cli/train.main with the counts
    reset just before."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.data.synthetic import \
        make_stand_in_cam_store

    root = data["root"]
    t0 = time.perf_counter()
    make_stand_in_cam_store(data["synth"]["metadata_root"],
                            os.path.join(root, "cams"), seed=seed)
    store_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with conv_weight_dtypes() as seen:
        out = cli_train.main(path_d_flags(root, os.path.join(root, "cams"),
                                          os.path.join(root, "exps")))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    convs = check_conv_dtypes("path D", seen, {"bfloat16", "float32"})
    rep = report_trainer("path D", out, PATH_D_EPOCHS)
    steps = rep["steps"]
    k = launches["bilateral_exact"]["kernel"]
    print(f"[path D launches] bilateral_exact {k} in {steps} steps "
          f"({k / steps:.2f} per step); {launches}", flush=True)
    check(k == steps, f"path D: the exact CRF kernel launched {k} times in "
          f"{steps} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path D: a plain version ran")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[path D] cli/train.main {wall_s:.2f} s (CAM store {store_s:.2f}"
          f" s), peak {peak:.2f} GiB", flush=True)
    return {"wall_s": wall_s, "gen_s": data["gen_s"], "store_s": store_s,
            "jpeg_round_trip_mean_abs": data["jpeg_round_trip_mean_abs"],
            "launches": launches, "steps": steps, "conv_dtypes": convs,
            "train": out["records"]["train"], "eval": out["records"]["eval"],
            "test_best_loc": rep["best"], "peak_mem_gib": peak,
            "outd": out["outd"]}


# ------------------------------------------ path G: the train data plane
# the JAX package's train data plane (cli/train.py flags): uint8 batches,
# the decoded-frame cache and the card-resident train feed, whose frames
# pool for path D's 640 frames at 256 px is 126 MB; path G keeps one step
# a dispatch (its history compares with earlier runs), path L takes JAX's
# default of 8
PATH_L_FLAGS = ["--h2d_transfer", "uint8", "--decode_cache_mb", "256",
                "--train_device_cache_mb", "256"]
PATH_G_FLAGS = PATH_L_FLAGS + ["--train_dispatch_chunk", "0"]
PATH_G_EPOCHS = 4
# one epoch-1 batch of the feed against the streamed route with the
# decoded-frame cache (JAX tests/test_device_feed.py's tolerances): the
# streamed CAM is packed to uint16 (7.6e-6) after the host's float32
# matrix resize, the feed's resizes on the card; ROI pixels on a
# threshold may flip
FEED_CAM_ATOL = 2e-4
FEED_ROI_AGREE = 0.995
FEED_FG_ATOL = 2e-3


def check_feed_batch(args, device: torch.device) -> dict:
    """The feed's first batch of epoch 1 against the streamed compact
    route (nvJPEG into the decoded-frame cache on the card, the CAM side
    on the host) for the same draws: ids, labels and uint8 pixels equal,
    the CAM side within the tolerances above."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.steps import expand_compact_batch

    _, feed_pipe, _ = cli_train.build_data(args, KeyChain(args.seed), device)
    _, stream_pipe, _ = cli_train.build_data(
        args.replace(train_device_cache_mb=0), KeyChain(args.seed), device)
    check(feed_pipe.data_route == "device_feed"
          and stream_pipe.data_route == "stream",
          f"path G check: routes {feed_pipe.data_route}, "
          f"{stream_pipe.data_route}")
    bd = next(iter(feed_pipe.epoch(1)))
    bs = next(iter(stream_pipe.epoch(1)))
    check(bd["image_id"] == bs["image_id"], "path G: the feed's epoch-1 "
          "batch holds other frames than the streamed route's")
    for k in ("raw_u8", "label", "valid", "seq_iter", "frm_iter"):
        check(torch.equal(bd[k], bs[k]), f"path G: the feed's {k} differs "
              "from the streamed route's")
    exp = expand_compact_batch(bs)
    cam_err = (bd["std_cam"] - exp["std_cam"]).abs().max().item()
    roi_agree = (bd["roi"] == exp["roi"]).float().mean().item()
    fg_err = (bd["fg_size"] - bs["fg_size"]).abs().max().item()
    print(f"[path G check] epoch-1 batch of {len(bd['image_id'])} frames: "
          f"ids, labels and uint8 pixels equal to the streamed route's; "
          f"std_cam max |diff| {cam_err:.3e} (tol {FEED_CAM_ATOL}), ROI "
          f"pixels agree {100 * roi_agree:.3f}% (at least "
          f"{100 * FEED_ROI_AGREE}%), fg_size max |diff| {fg_err:.3e} (tol "
          f"{FEED_FG_ATOL})", flush=True)
    check(cam_err <= FEED_CAM_ATOL, f"path G: std_cam {cam_err:.3e} off")
    check(roi_agree >= FEED_ROI_AGREE, f"path G: ROI agrees {roi_agree}")
    check(fg_err <= FEED_FG_ATOL, f"path G: fg_size {fg_err:.3e} off")
    del feed_pipe, stream_pipe
    torch.cuda.empty_cache()
    return {"std_cam_max_abs": cam_err, "roi_agree": roi_agree,
            "fg_size_max_abs": fg_err}


def phase_feed(seed: int, data: dict) -> dict:
    """Path G: cli/train.main with path D's flags and PATH_G_FLAGS for
    PATH_G_EPOCHS epochs over path D's stand-in store, counts reset just
    before: the train epochs come from the card-resident feed (every
    epoch's data_route), each sampled frame is decoded once, the exact CRF
    kernel launches once a step; then one epoch-1 batch against the
    streamed route."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core.config import parse_args
    from tcam_wsol_video_tpu_torch.data import native_loader
    from tcam_wsol_video_tpu_torch.data import pipeline as port_pipeline

    root = data["root"]
    flags = path_d_flags(root, os.path.join(root, "cams"),
                         os.path.join(root, "exps_g"), epochs=PATH_G_EPOCHS,
                         exp_id="g") + PATH_G_FLAGS
    feeds = []
    base = port_pipeline.DeviceTrainFeed

    class Spy(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            feeds.append(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    port_pipeline.DeviceTrainFeed = Spy
    try:
        t0 = time.perf_counter()
        out = cli_train.main(flags)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        port_pipeline.DeviceTrainFeed = base
    launches = read_counts()
    rep = report_trainer("path G", out, PATH_G_EPOCHS)
    steps = rep["steps"]
    train = out["records"]["train"]
    for r in train:
        print(f"[path G epoch {r['epoch']}] route {r['data_route']}, data "
              f"wait {r['data_wait_ms_per_step']:.2f} ms/step (pool fill "
              f"{r['data_pixels_ms_per_step']:.2f}, plan "
              f"{r['data_plan_ms']:.2f} ms in the epoch), pool misses "
              f"{r['pool_misses']}, decodes {r['pool_decodes']}, assembly "
              f"{r['data_assembly_ms_per_step']:.3f} ms/step (CUDA events), "
              f"median step {r['median_step_ms']:.2f} ms", flush=True)
        check(r["data_route"] == "device_feed", f"path G epoch {r['epoch']}"
              f": data route {r['data_route']}")
    feed = [f for f in feeds if f.enabled]
    check(len(feed) == 1, f"path G: {len(feed)} enabled train feeds")
    feed = feed[0]
    decodes = sum(r["pool_decodes"] for r in train)
    sampled = int(feed.resident.sum())
    print(f"[path G] frames pool {feed.frames_pool.numel() / 2 ** 20:.1f} MiB for "
          f"{len(feed.frames)} frames; {sampled} distinct frames sampled in "
          f"{PATH_G_EPOCHS} epochs, {decodes} decodes, at most "
          f"{int(feed.decodes.max())} a frame", flush=True)
    check(int(feed.decodes.max()) == 1 and decodes == sampled
          == int(feed.decodes.sum()), "path G: a sampled frame was decoded "
          "more than once, or not counted")
    k = launches["bilateral_exact"]["kernel"]
    print(f"[path G launches] bilateral_exact {k} in {steps} steps; "
          f"{launches}; cli/train.main {wall_s:.2f} s", flush=True)
    check(k == steps, f"path G: the exact CRF kernel launched {k} times in "
          f"{steps} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path G: a plain version ran")
    check(native_loader._lib.cache_info().currsize == 0,
          "path G: a card pipeline loaded the host's libjpeg route")
    del feeds, feed
    torch.cuda.empty_cache()
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--device")
    args, _ = parse_args(flags, extra)
    batch_check = check_feed_batch(args, torch.device("cuda"))
    return {"wall_s": wall_s, "launches": launches, "steps": steps,
            "decodes": decodes, "sampled_frames": sampled,
            "train": train, "eval": out["records"]["eval"],
            "test_best_loc": rep["best"], "batch_check": batch_check,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# ------------------------- path L: K steps a dispatch as CUDA graphs
PATH_L_EPOCHS = 2
# the chunked route against the per-step route from the same weights (JAX
# tests/test_device_feed.py::test_chunked_dispatch_matches_per_step): the
# first step's loss at bf16 (the same kernels on the same inputs, cuDNN
# free to pick its algorithms in and out of a graph), epoch 0's loss
# (rtol 1e-3) and epoch 1's (rtol 5e-2, training dynamics: the seeder's
# discrete decisions flip on ~1e-7 differences)
CHUNK_FIRST_RTOL = 1e-3
CHUNK_EPOCH_RTOL = (1e-3, 5e-2)


class PlanSpy:
    """Records every epoch plan a card-resident feed draws: (epoch, frame
    ids, plan arrays)."""

    def __init__(self):
        from tcam_wsol_video_tpu_torch.data.device_feed import \
            DeviceTrainFeed
        self.cls = DeviceTrainFeed
        self.orig = DeviceTrainFeed._plan_epoch
        self.plans = []

    def __enter__(self):
        spy = self

        def plan_epoch(feed, epoch, subset=None):
            out = spy.orig(feed, epoch, subset)
            spy.plans.append((epoch, out[1], out[0]))
            return out
        self.cls._plan_epoch = plan_epoch
        return self

    def __exit__(self, *exc):
        self.cls._plan_epoch = self.orig


def _train_step_losses(outd: str) -> list:
    with open(os.path.join(outd, "log.json")) as f:
        return [json.loads(x)["loss"] for x in f
                if '"it"' in x and '"split": "train"' in x]


def phase_chunked(seed: int, data: dict) -> dict:
    """Path L: cli/train.main with path G's data flags and JAX's default
    train_dispatch_chunk 8 for PATH_L_EPOCHS epochs (each epoch's 5 steps
    one CUDA graph replay), then the same epochs from the same weights at
    --train_dispatch_chunk 0; counts reset just before each.  Per route:
    the median step, the host's enqueue and the data wait a step, the
    epoch wall time and kernel 1's launches (one a step, through the
    replays); the routes' plans equal, the first step's loss and the epoch
    losses within the tolerances above."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train

    root = data["root"]
    routes = {}
    for name, extra in (("chunked", []),
                        ("per_step", ["--train_dispatch_chunk", "0"])):
        flags = path_d_flags(root, os.path.join(root, "cams"),
                             os.path.join(root, "exps_l"),
                             epochs=PATH_L_EPOCHS, exp_id=f"l_{name}")
        flags[flags.index("--log_every") + 1] = "1"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with PlanSpy() as plans:
            t0 = time.perf_counter()
            out = cli_train.main(flags + PATH_L_FLAGS + extra)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = read_counts()
        rep = report_trainer(f"path L {name}", out, PATH_L_EPOCHS)
        train = out["records"]["train"]
        k = launches["bilateral_exact"]["kernel"]
        for r in train:
            print(f"[path L {name} epoch {r['epoch']}] dispatch "
                  f"{r['dispatch']} K={r['dispatch_chunk']}, median step "
                  f"{r['median_step_ms']:.2f} ms, host enqueue "
                  f"{r['host_enqueue_ms_per_step']:.2f} ms/step, data wait "
                  f"{r['data_wait_ms_per_step']:.2f} ms/step (plan "
                  f"{r['data_plan_ms']:.2f} ms, pool fill "
                  f"{r['data_fill_ms']:.2f} ms, {r['pool_decodes']} decodes)"
                  f", graph capture {r['capture_ms']:.1f} ms, epoch wall "
                  f"{r['wall_ms']:.1f} ms, loss {r['loss']:.6g}",
                  flush=True)
            check(r["data_route"] == "device_feed" and r["dispatch"] == name,
                  f"path L {name}: route {r['data_route']}/{r['dispatch']}")
        print(f"[path L {name} launches] bilateral_exact {k} in "
              f"{rep['steps']} steps; {launches}; cli/train.main "
              f"{wall_s:.2f} s", flush=True)
        check(k == rep["steps"], f"path L {name}: the exact CRF kernel "
              f"launched {k} times in {rep['steps']} steps")
        check(all(c["plain"] == 0 for c in launches.values()),
              f"path L {name}: a plain version ran")
        routes[name] = {
            "wall_s": wall_s, "launches": launches, "steps": rep["steps"],
            "train": train, "eval": out["records"]["eval"],
            "test_best_loc": rep["best"], "plans": plans.plans,
            "step_losses": _train_step_losses(out["outd"]),
            "outd": out["outd"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    ch, ps = routes["chunked"], routes["per_step"]
    check(len(ch["plans"]) == len(ps["plans"]) == PATH_L_EPOCHS,
          "path L: plans drawn per route "
          f"{len(ch['plans'])}/{len(ps['plans'])}")
    for (ea, ia, pa), (eb, ib, pb) in zip(ch["plans"], ps["plans"]):
        check(ea == eb and ia == ib and all(
            np.array_equal(pa[k], pb[k]) for k in pa),
            f"path L: epoch {ea}'s plan differs between the routes")
    first = (ch["step_losses"][0], ps["step_losses"][0])
    first_rel = abs(first[0] - first[1]) / abs(first[1])
    epoch_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(ch["train"], ps["train"])]
    print(f"[path L] plans equal in {PATH_L_EPOCHS} epochs; first step's "
          f"loss {first[0]:.8g} chunked / {first[1]:.8g} per-step (rel "
          f"{first_rel:.3e}, tol {CHUNK_FIRST_RTOL}); epoch losses rel "
          + "/".join(f"{e:.3e}" for e in epoch_rel)
          + f" (tol {'/'.join(str(t) for t in CHUNK_EPOCH_RTOL)})",
          flush=True)
    check(first_rel <= CHUNK_FIRST_RTOL, "path L: first step's loss")
    for e, tol in zip(epoch_rel, CHUNK_EPOCH_RTOL):
        check(e <= tol, f"path L: epoch loss rel {e:.3e} over {tol}")
    for r in routes.values():
        r.pop("plans")
    return {"routes": routes, "first_step_rel": first_rel,
            "epoch_loss_rel": epoch_rel,
            "snapshot": os.path.join(ch["outd"], "best_localization")}


# ------------------------------------------- the eval-knob phase (path L)
def _counters_equal(a: dict, b: dict) -> bool:
    keys = ("maxboxacc_30", "maxboxacc_50", "maxboxacc_70", "top1_loc_30",
            "top1_loc_50", "top1_loc_70", "top5_loc_30", "top5_loc_50",
            "top5_loc_70", "classification", "n_images")
    return (all(a[k] == b[k] for k in keys) and a["best_tau"] == b["best_tau"]
            and all(np.array_equal(a["curves"][s], b["curves"][s])
                    and np.array_equal(a["curves"]["top1"][s],
                                       b["curves"]["top1"][s])
                    and np.array_equal(a["curves"]["top5"][s],
                                       b["curves"]["top5"][s])
                    for s in (30, 50, 70)))


class ReplayPipe:
    """An eval pipeline that replays batches made once, so that every eval
    knob sees the same pixels."""

    def __init__(self, batches: list, device):
        self.batches = batches
        self.device = torch.device(device)

    def epoch(self, epoch: int):
        yield from self.batches


def phase_eval_knobs(seed: int, data: dict, snapshot: str) -> dict:
    """The eval knobs on path D's test split (320 frames, uint8 batches of
    32) at path L's best-localization snapshot, through CamEvaluator: the
    exact counters bit-equal for eval_transfer float32/uint16/uint8,
    eval_sweep host/device, eval_pipeline_depth 1/8 and the device cache's
    second pass against its first; images/s of each, the device sweep's
    host-swept fallbacks, and on_device_eval's approximate MaxBoxAcc
    beside the exact one.  The knobs are held on one set of batches (the
    split decoded once and replayed; a pass that decodes runs first, for
    its images/s); the frames in which two decodes of the split differ
    are counted and printed."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.core.config import parse_args
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
    from tcam_wsol_video_tpu_torch.engine import evaluator
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args

    root = data["root"]
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--device")
    args, _ = parse_args(path_d_flags(root, os.path.join(root, "cams"),
                                      os.path.join(root, "exps_l"))
                         + PATH_L_FLAGS, extra)
    args = cli_train.resolve_metadata_root(args)
    kc = KeyChain(seed)
    ds = cli_train.eval_dataset(args, kc, constants.TESTSET)
    step, payload = ckpt.load_best_model(snapshot)
    check(payload is not None, f"eval knobs: no snapshot under {snapshot}")
    model = create_model_from_args(args, device="cuda")
    ckpt.load_components(model, payload["components"])

    def pipe():
        return DataPipeline(ds, args.eval_batch_size, kc, shuffle=False,
                            compact=True, device="cuda")

    def decoded():
        out = list(pipe().epoch(0))
        torch.cuda.synchronize()
        return out

    batches, again = decoded(), decoded()
    differ = sum(int((a["raw_u8"] != b["raw_u8"]).flatten(1).any(1).sum())
                 for a, b in zip(batches, again))
    print(f"[eval knobs] the test split decoded twice: {differ} of "
          f"{sum(len(b['image_id']) for b in batches)} frames differ",
          flush=True)
    del again
    variants = [
        ("decoding pass", {}),
        ("host f32 depth 8", {}),
        ("host f32 depth 1", {"eval_pipeline_depth": 1}),
        ("host uint16", {"eval_transfer": "uint16"}),
        ("host uint8", {"eval_transfer": "uint8"}),
        ("device sweep", {"eval_sweep": "device"}),
        ("device sweep uint8", {"eval_sweep": "device",
                                "eval_transfer": "uint8"}),
        ("cache pass 1", {"eval_device_cache": True}),
        ("cache pass 2", {"eval_device_cache": True}),
        ("on_device", {"on_device_eval": True})]
    cache_pipe = ReplayPipe(batches, "cuda")
    out = {}
    for name, knobs in variants:
        p = (pipe() if name == "decoding pass" else cache_pipe
             if name.startswith("cache") else ReplayPipe(batches, "cuda"))
        torch.cuda.synchronize()
        res = evaluator.CamEvaluator(
            model, args.replace(**knobs), ds, p, constants.TESTSET,
            generator=kc.key("eval", "knobs", device="cuda")).run()
        t = res["timing"]
        out[name] = {k: v for k, v in res.items() if k != "curves"}
        out[name]["curves"] = res["curves"]
        print(f"[eval knobs] {name}: {res['n_images']} images, "
              f"{t['images_per_s']:.1f} images/s (sweep {t['sweep']}, depth "
              f"{t['pipeline_depth']}, cache {t['device_cache']}), eval "
              f"step {t['forward_ms_per_batch']:.2f} ms/batch, MaxBoxAcc "
              f"30/50/70 {res['maxboxacc_30']:.2f}/{res['maxboxacc_50']:.2f}"
              f"/{res['maxboxacc_70']:.2f}"
              + (f", device-sweep fallbacks {res['sweep_fallbacks']}"
                 if "sweep_fallbacks" in res else ""), flush=True)
        check(res["n_images"] == 320, f"eval knobs {name}: "
              f"{res['n_images']} images")
    base = out["host f32 depth 8"]
    for name, _ in variants[2:-1]:
        check(_counters_equal(out[name], base), f"eval knobs: {name}'s "
              "counters differ from host f32 depth 8's")
    check(out["cache pass 2"]["timing"]["device_cache"] == "replayed",
          "eval knobs: the cache's second pass did not replay")
    od = out["on_device"]
    print("[eval knobs] counters bit-equal across every exact variant; "
          "on_device_eval (approximate) MaxBoxAcc 30/50/70 "
          + "/".join(f"{od[f'maxboxacc_{s}']:.2f}" for s in (30, 50, 70))
          + " against the exact "
          + "/".join(f"{base[f'maxboxacc_{s}']:.2f}" for s in (30, 50, 70)),
          flush=True)
    for r in out.values():
        r.pop("curves", None)
    del model, cache_pipe
    torch.cuda.empty_cache()
    return {"snapshot_step": step, "variants": out,
            "frames_decoded_differently": differ}


# --------------------------------------- loss_chunk and remat at path A
# the chunked loss against the plain step's at bf16: the same terms summed
# by groups of 8 frames (fp32 sums in another order; the CE's count)
LOSS_CHUNK_RTOL = 1e-3


def phase_loss_chunk_remat(seed: int) -> dict:
    """Path A's step (bs 32, 224 px, bf16) from the same weights, batch and
    seeder noise: plain, with loss_chunk 8 and with remat.  The losses
    within LOSS_CHUNK_RTOL of the plain step's; remat's parameter update
    and BN statistics within BF16_RTOL of the plain step's (relative to
    their largest values); the peak memory of each, and kernel 1's
    launches a step under chunking (one a group of frames, and one
    more as the backward recomputes the group)."""
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam

    runs = {}
    for name, knobs in (("plain", {}), ("loss_chunk 8", {"loss_chunk": 8}),
                        ("remat", {"remat": True})):
        (args, model, opt, state, _, _, batch, gen,
         switches) = build_main_path(seed)
        args = args.replace(**knobs)
        step = make_train_step(get_loss_tcam(args), args,
                               seeder_cfg_from_args(args))
        before = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        met = step(state, batch, switches, seed_weighted=True, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        runs[name] = {
            "metrics": {k: float(v) for k, v in met.items()},
            "step_ms": ms, "peak_mem_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "kernel_launches": launches["bilateral_exact"]["kernel"],
            "delta": {k: (v.detach().float() - before[k].float())
                      for k, v in model.state_dict().items()}}
        print(f"[loss_chunk/remat] {name}: loss "
              f"{runs[name]['metrics']['loss']:.8g}, step {ms:.2f} ms "
              f"(first call), peak {runs[name]['peak_mem_gib']:.2f} GiB, "
              f"bilateral_exact {runs[name]['kernel_launches']} launches "
              f"in the step", flush=True)
        check(all(c["plain"] == 0 for c in launches.values()),
              f"loss_chunk/remat {name}: a plain version ran")
        del model, opt, state, batch
        torch.cuda.empty_cache()
    plain = runs["plain"]
    for name in ("loss_chunk 8", "remat"):
        r = runs[name]
        rel = {k: abs(r["metrics"][k] - v) / max(abs(v), 1e-30)
               for k, v in plain["metrics"].items()
               if k not in ("n", "n_correct")}
        print(f"[loss_chunk/remat] {name} against plain: rel " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items()), flush=True)
        check(abs(r["metrics"]["loss"] - plain["metrics"]["loss"])
              <= LOSS_CHUNK_RTOL * abs(plain["metrics"]["loss"]),
              f"{name}: loss off the plain step's")
    # each group's checkpointed body runs again in the backward
    check(runs["loss_chunk 8"]["kernel_launches"] == 8,
          "loss_chunk 8: kernel 1 launched "
          f"{runs['loss_chunk 8']['kernel_launches']} times for 4 groups, "
          "each recomputed once")
    check(runs["plain"]["kernel_launches"] == runs["remat"][
        "kernel_launches"] == 1, "plain/remat: kernel 1 once a step")
    worst = {}
    for kind, keys in (
            ("params", [k for k in plain["delta"] if not k.endswith((
                "running_mean", "running_var", "num_batches_tracked"))]),
            ("bn_stats", [k for k in plain["delta"]
                          if k.endswith(("running_mean", "running_var"))])):
        scale = max(float(plain["delta"][k].abs().max()) for k in keys)
        err = max(float((runs["remat"]["delta"][k]
                         - plain["delta"][k]).abs().max()) for k in keys)
        worst[kind] = err / scale
        print(f"[loss_chunk/remat] remat {kind} update: max |diff| "
              f"{err:.3e} against the plain update's largest {scale:.3e} "
              f"(rel {err / scale:.3e}, tol {BF16_RTOL})", flush=True)
        check(err <= BF16_RTOL * scale, f"remat: {kind} off the plain "
              "step's")
    for r in runs.values():
        r.pop("delta")
    return {"runs": runs, "remat_rel": worst}


# ROI pixels of the card's roi_batch against the host route (scipy labels,
# float64 densities) on blobs that the 128 propagation steps cover: they
# differ only where an Otsu histogram edge or a density near-tie falls
# apart in float32
ROI_AGREE = 0.999


def roi_cams(rng: np.random.Generator, b: int, size: int) -> np.ndarray:
    """1-4 Gaussian blobs a map (sigma 4-14 px, so that each component's
    in-component paths stay under 128 steps), max-normalized to [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.zeros((b, size, size), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(20, size - 20, 2)
            sig = rng.uniform(4.0, 14.0)
            out[i] = np.maximum(out[i], rng.uniform(0.3, 1.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig * sig)))
        out[i] /= out[i].max()
    return out


def phase_roi(seed: int, b: int = 32, size: int = 224) -> dict:
    """roi_batch of ROI_LARGEST and ROI_H_DENSITY on the card (Otsu
    thresholds, min-propagation labels, 64 component slots) against
    roi_one_cam_np on the host, at the feed's shapes, and timed."""
    from tcam_wsol_video_tpu_torch.cams.roi import roi_batch, roi_one_cam_np
    from tcam_wsol_video_tpu_torch.core import constants

    cams = roi_cams(np.random.default_rng(seed + 5), b, size)
    dev = torch.from_numpy(cams).cuda()
    out = {}
    for method in (constants.ROI_LARGEST, constants.ROI_H_DENSITY):
        roi, mask, box = (t.cpu().numpy() for t in roi_batch(dev, method))
        t0 = time.perf_counter()
        host = [roi_one_cam_np(c, method) for c in cams]
        host_ms = (time.perf_counter() - t0) * 1e3
        agree = float(np.mean([(roi[i] == h[0]).mean()
                               for i, h in enumerate(host)]))
        same = sum(bool((roi[i] == h[0]).all() and (box[i] == h[2]).all()
                        and (mask[i] == h[1]).all())
                   for i, h in enumerate(host))
        ms = cuda_time_ms(lambda: roi_batch(dev, method), reps=10)
        print(f"[roi] {method} at B={b}, {size}x{size}: card "
              f"{ms:.3f} ms a batch (CUDA events), host route "
              f"{host_ms:.1f} ms; ROI pixels agree {100 * agree:.4f}% (at "
              f"least {100 * ROI_AGREE}%), {same}/{b} maps equal in ROI, "
              f"box and mask", flush=True)
        check(agree >= ROI_AGREE, f"roi {method}: the card's ROI agrees "
              f"{agree} with the host route's")
        out[method] = {"ms": ms, "host_ms": host_ms, "agree": agree,
                       "maps_equal": same}
    return out


# -------------------------------------------- path E: the two-stage chain
def check_dump_route(data: dict, dump_args, s1_dir: str) -> dict:
    """The dump's pixels on the card (nvJPEG, then Pillow's bilinear
    arithmetic) against the source frames through the same resize on the
    CPU; one dump batch's CAMs on the card against the port's CPU run on
    the same pixels and weights, both at float32 (`dump_args`); and the
    same batch on the card at the dump's default bfloat16 against the
    card's float32."""
    from tcam_wsol_video_tpu_torch.cli import dump_cams as cli_dump
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.transforms import \
        pil_bilinear_resize

    synth = data["synth"]
    crop = dump_args.crop_size
    fids = list(synth["frames"])
    card = nvjpeg_loader.load_resized_u8(
        [os.path.join(synth["data_root"], f) for f in fids], (crop, crop))
    src = pil_bilinear_resize(torch.from_numpy(np.stack(
        [synth["frames"][f] for f in fids])), (crop, crop))
    errs = (card.cpu().double() - src.double()).abs().mean(
        dim=(1, 2, 3)).tolist()
    print(f"[path E dump] pixel route of {len(errs)} frames ({crop} x {crop}"
          f", Pillow's bilinear): mean |card - source| median "
          f"{statistics.median(errs):.3f}, max {max(errs):.3f} levels (tol "
          f"{JPEG_MEAN_ABS_TOL})", flush=True)
    check(max(errs) <= JPEG_MEAN_ABS_TOL, f"path E: the dump's pixel route "
          f"is {max(errs):.3f} levels off the source")

    data_root, frames = cli_dump.train_frames(dump_args)
    chunk = frames[:32]
    pixels = cli_dump.load_pixels([os.path.join(data_root, f)
                                   for f, _ in chunk], crop,
                                  torch.device("cuda"))
    labels = torch.tensor([lab for _, lab in chunk])
    cams = {}
    for dev, args in (("cuda", dump_args), ("cpu", dump_args),
                      ("cuda bf16", dump_args.replace(
                          compute_dtype="bfloat16"))):
        device = torch.device(dev.split()[0])
        model, _, _ = cli_dump.load_classifier(args, s1_dir, device)
        step = cli_dump.make_dump_step(model, args, 28)
        t0 = time.perf_counter()
        cams[dev] = step(pixels.to(device), labels.to(device)).cpu()
        print(f"[path E dump] one batch of {len(chunk)} CAMs on {dev}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del model
    err = (cams["cuda"] - cams["cpu"]).abs().max().item()
    print(f"[path E dump] CAMs card (fp32, TF32 convolutions) vs CPU (fp32):"
          f" max |difference| {err:.3e} (tol {CAM_TF32_ATOL})", flush=True)
    check(err <= CAM_TF32_ATOL, f"path E: the card's CAMs are {err:.3e} off "
          "the CPU's")
    err16 = (cams["cuda bf16"] - cams["cuda"]).abs().max().item()
    print(f"[path E dump] CAMs card bf16 vs card fp32: max |difference| "
          f"{err16:.3e} (tol {CAM_BF16_ATOL})", flush=True)
    check(err16 <= CAM_BF16_ATOL, f"path E: the card's bf16 CAMs are "
          f"{err16:.3e} off its fp32 ones")
    torch.cuda.empty_cache()
    return {"pixel_route_mean_abs": errs, "cam_card_vs_cpu_max_abs": err,
            "cam_atol": CAM_TF32_ATOL, "cam_bf16_vs_fp32_max_abs": err16,
            "cam_bf16_atol": CAM_BF16_ATOL}


def phase_chain(seed: int, data: dict) -> dict:
    """Path E: the two-stage chain through the CLIs a user runs, with the
    counts reset just before: stage 1 (STD_CL), dump_cams at its
    best-localization snapshot, stage 2 (TCAM) over the dumped store from
    stage 1's best-classification encoder and head, and the standalone
    evaluate at stage 2's best-localization snapshot on the test split."""
    from tcam_wsol_video_tpu_torch.cli import dump_cams as cli_dump
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.core.config import stage1_cam_recipe
    from tcam_wsol_video_tpu_torch.data.cam_store import CamStore

    root = data["root"]
    outd = os.path.join(root, "exps_e")
    store_dir = os.path.join(root, "cam_store")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_chain = time.perf_counter()

    convs = {}
    # stage 1
    t0 = time.perf_counter()
    with conv_weight_dtypes() as seen:
        s1 = cli_train.main(path_e_stage1_flags(root, outd))
    torch.cuda.synchronize()
    s1_s = time.perf_counter() - t0
    convs["stage1"] = check_conv_dtypes("path E stage 1", seen,
                                        {"bfloat16", "float32"})
    rep1 = report_trainer("path E stage 1", s1, PATH_E_EPOCHS)
    print(f"[path E stage 1] cli/train.main {s1_s:.2f} s", flush=True)

    # the handoff
    dump_flags = common_flags(root) + ["--task", "STD_CL", "--exp_dir",
                                       s1["outd"], "--out", store_dir]
    with conv_weight_dtypes() as seen:
        dump = cli_dump.main(dump_flags)
    torch.cuda.synchronize()
    convs["dump"] = check_conv_dtypes("path E dump", seen, {"bfloat16"})
    store = CamStore(store_dir)
    th = store.thresholds or {}
    cams_ok = all(
        store.load_cam(f).shape == (28, 28)
        and 0.0 <= store.load_cam(f).min()
        and store.load_cam(f).max() <= 1.0 for f in th)
    print(f"[path E dump] {dump['n_frames']} frames of the "
          f"{constants.BEST_LOC} snapshot (step {dump['step']}) in "
          f"{dump['seconds']:.2f} s: {dump['frames_per_s']:.1f} frames/s "
          f"(host: CAMs saved and thresholds {dump['host_s']:.2f} s); "
          f"{len(th)} thresholds in [{min(th.values()):.4f}, "
          f"{max(th.values()):.4f}]", flush=True)
    check(dump["step"] > 0, f"path E: the dump read stage 1's untrained "
          f"{constants.BEST_LOC} snapshot (step {dump['step']})")
    check(dump["n_frames"] == len(th) == 640 and cams_ok
          and all(0.0 <= t <= 1.0 for t in th.values()),
          f"path E: {len(th)} thresholds for {dump['n_frames']} frames, "
          f"CAMs 28 x 28 in [0, 1]: {cams_ok}")
    route = check_dump_route(data, stage1_cam_recipe(
        crop_size=224, resize_size=256, data_root=root,
        metadata_root=os.path.join(root, "folds"), seed=seed,
        compute_dtype="float32"), s1["outd"])

    # stage 2, from stage 1's best-classification encoder and head; its
    # own random weights come from another seed, so they equal stage 1's
    # only if the load took place
    loaded = {}
    load = cli_train.load_pretrained_classifier_weights
    held = (("classification_head", "fc.weight"), ("encoder", "conv1.weight"))

    def weights(model):
        # copies: the steps update the parameters in place
        return {(c, n): getattr(model, c).state_dict()[n].to("cpu", copy=True)
                for c, n in held}

    def spy(args, model):
        loaded["before"] = weights(model)
        load(args, model)
        loaded["after"] = weights(model)

    cli_train.load_pretrained_classifier_weights = spy
    try:
        t0 = time.perf_counter()
        with conv_weight_dtypes() as seen:
            s2 = cli_train.main(path_d_flags(root, store_dir, outd,
                                             pretrained=s1["outd"],
                                             seed=SEED + 1))
        torch.cuda.synchronize()
        s2_s = time.perf_counter() - t0
    finally:
        cli_train.load_pretrained_classifier_weights = load
    launches = read_counts()
    convs["stage2"] = check_conv_dtypes("path E stage 2", seen,
                                        {"bfloat16", "float32"})
    cl_step, snap = ckpt.load_best_model(os.path.join(s1["outd"],
                                                      constants.BEST_CL))
    want = {(c, n): snap["components"][c][n] for c, n in held}
    differ = "before" in loaded and not any(
        torch.equal(loaded["before"][k], v) for k, v in want.items())
    same = "after" in loaded and all(
        torch.equal(loaded["after"][k], v) for k, v in want.items())
    print(f"[path E stage 2] starts from stage 1's {constants.BEST_CL} "
          f"snapshot (step {cl_step}): "
          f"{' and '.join(f'{c}.{n}' for c, n in held)} differ from it "
          f"before the load (seed {SEED + 1}) {differ}, equal it after "
          f"{same}", flush=True)
    check(differ and same, "path E: stage 2 did not start from stage 1's "
          "weights")
    check(cl_step > 0, f"path E: stage 2 started from stage 1's untrained "
          f"{constants.BEST_CL} snapshot (step {cl_step})")
    rep2 = report_trainer("path E stage 2", s2, PATH_D_EPOCHS)
    k = launches["bilateral_exact"]["kernel"]
    print(f"[path E launches] bilateral_exact {k} in {rep2['steps']} "
          f"stage-2 steps; {launches}", flush=True)
    check(k == rep2["steps"], f"path E: the exact CRF kernel launched {k} "
          f"times in {rep2['steps']} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path E: a plain version ran")
    print(f"[path E stage 2] cli/train.main {s2_s:.2f} s", flush=True)

    # standalone evaluation of stage 2's best-localization snapshot
    t0 = time.perf_counter()
    with conv_weight_dtypes() as seen:
        ev = cli_eval.main(common_flags(root) + [
            "--task", "TCAM", "--arch", "UnetTCAM", "--eval_batch_size",
            "32", "--exp_dir", s2["outd"], "--split", "test"])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    convs["evaluate"] = check_conv_dtypes("path E evaluate", seen,
                                          {"float32"})
    after = read_counts()
    check(after == launches, f"path E: evaluate launched kernels: {after}")
    want = rep2["best"]
    gaps = {s: abs(ev[f"maxboxacc_{s}"] - want[f"maxboxacc_{s}"])
            for s in (30, 50, 70)}
    share = 100.0 / 320
    print(_eval_line("path E evaluate test best_localization",
                     {**ev, **ev["timing"]})
          + f"; |evaluate - trainer| at IoU 30/50/70 "
          + "/".join(f"{g:.4f}" for g in gaps.values())
          + f" (tol {share:.4f}, one image); cli/evaluate.main "
          f"{ev_s:.2f} s", flush=True)
    check(ev["n_images"] == 320 and max(gaps.values()) <= share,
          f"path E: evaluate is {gaps} off the trainer's test pass")
    wall_s = time.perf_counter() - t_chain
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[path E] the chain in {wall_s:.2f} s (stage 1 {s1_s:.2f}, dump "
          f"{dump['seconds']:.2f}, stage 2 {s2_s:.2f}, evaluate "
          f"{ev_s:.2f}), peak {peak:.2f} GiB", flush=True)
    return {"wall_s": wall_s, "stage1_s": s1_s, "stage2_s": s2_s,
            "evaluate_s": ev_s, "launches": launches,
            "stage1_outd": s1["outd"],
            "stage1": {"train": s1["records"]["train"],
                       "eval": s1["records"]["eval"],
                       "test_best_loc": rep1["best"]},
            "dump": {k: v for k, v in dump.items() if k != "store"},
            "dump_route": route,
            "stage2": {"steps": rep2["steps"],
                       "train": s2["records"]["train"],
                       "eval": s2["records"]["eval"],
                       "test_best_loc": want},
            "evaluate": dict(ev), "conv_dtypes": convs,
            "evaluate_gap": gaps, "peak_mem_gib": peak}


# ------------------------------------- path F: TCAM without a CAM store
def phase_recompute(seed: int, data: dict, s1_outd: str) -> dict:
    """Path F: cli/train.main with path D's stage-2 flags but no CAM store
    and --sl_tc_use_roi false, from path E's stage-1 folder, 1 epoch: each
    step recomputes the seed CAMs from the frozen classifier of the
    folder's best-localization snapshot.  Counts reset just before; the
    CAMs handed to the seeder are recorded on the card (one max per
    image, read after the run)."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.engine import steps as port_steps

    root = data["root"]
    seen = []
    seeder = port_steps.tcam_seeder

    def spy(cams, cfg, **kw):
        seen.append(cams.detach().amax(dim=(1, 2)))
        return seeder(cams, cfg, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    port_steps.tcam_seeder = spy
    try:
        t0 = time.perf_counter()
        with conv_weight_dtypes() as conv_seen:
            out = cli_train.main(path_d_flags(
                root, "", os.path.join(root, "exps_f"), pretrained=s1_outd,
                seed=SEED + 2, epochs=1, use_roi=False, exp_id="f"))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        port_steps.tcam_seeder = seeder
    launches = read_counts()
    convs = check_conv_dtypes("path F", conv_seen, {"bfloat16", "float32"})
    rep = report_trainer("path F", out, 1)
    steps = rep["steps"]
    cam_max = torch.stack(seen).cpu() if seen else torch.zeros(0)
    k = launches["bilateral_exact"]["kernel"]
    print(f"[path F] seeder classifier from stage 1's best_localization "
          f"snapshot (step {out['seeder_step']}); {len(seen)} recomputed "
          f"batches in {steps} steps, per-image CAM max "
          f"{cam_max.min().item() if seen else 0.0:.4f} at least; "
          f"bilateral_exact {k} launches; cli/train.main {wall_s:.2f} s; "
          f"{launches}", flush=True)
    check(out["seeder_step"] is not None and out["seeder_step"] > 0,
          f"path F: the seeder classifier is stage 1's untrained snapshot "
          f"(step {out['seeder_step']})")
    check(len(seen) == steps and bool((cam_max > 0.0).all()),
          "path F: the seeder did not get the classifier's CAMs every step")
    check(k == steps, f"path F: the exact CRF kernel launched {k} times in "
          f"{steps} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path F: a plain version ran")
    return {"wall_s": wall_s, "seeder_step": out["seeder_step"],
            "launches": launches, "steps": steps, "conv_dtypes": convs,
            "cam_max_min": cam_max.min().item(),
            "train": out["records"]["train"], "eval": out["records"]["eval"],
            "test_best_loc": rep["best"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# ------------------------------ path H: the stage-2 recipe from its yaml
PATH_H_EPOCHS = 3
PATH_I_EPOCHS = 2


def path_h_flags(root: str, store: str, outd: str) -> list:
    """cli/train.py --config config_yaml/ytov1_stage2_tcam.yaml over path
    D's set and stand-in store at bs 32 / 224 px, with the production
    script's --crf_impl landmarks, image reconstruction and the
    best-student seed switch from epoch 1, PATH_H_EPOCHS epochs."""
    return ["--config", os.path.join(ROOT, "config_yaml",
                                     "ytov1_stage2_tcam.yaml")] + \
        common_flags(root) + [
        "--eval_batch_size", "32", "--max_epochs", str(PATH_H_EPOCHS),
        "--crf_impl", "landmarks", "--im_rec", "true",
        "--sl_tc_epoch_switch_to_sl", "1", "--checkpoint_save", "0",
        "--std_cams_folder", store, "--outd", outd, "--exp_id", "h"]


class RoiTimer:
    """CUDA events around each roi_batch call of the train steps (the
    student seed source's ROI_LARGEST); read after the run."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from tcam_wsol_video_tpu_torch.engine import steps as port_steps
        self.mod, self.fn = port_steps, port_steps.roi_batch

        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **k)
            e1.record()
            self.events.append((e0, e1))
            return out
        self.mod.roi_batch = timed
        return self

    def __exit__(self, *exc):
        self.mod.roi_batch = self.fn

    def millis(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def phase_recipe_yaml(seed: int, data: dict) -> dict:
    """Path H: cli/train.main with path_h_flags, counts reset just before:
    the seed source is the stored CAMs in epoch 0 and the best student
    from epoch 1 on (loaded once a best-localization epoch, its
    roi_batch timed in each step), K_nm built twice a step (kernel 4),
    no exact filter."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train

    root = data["root"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with RoiTimer() as roi_timer:
        out = cli_train.main(path_h_flags(root, os.path.join(root, "cams"),
                                          os.path.join(root, "exps_h")))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    roi_ms = roi_timer.millis()
    args = out["args"]
    print(f"[path H] --config config_yaml/ytov1_stage2_tcam.yaml: task "
          f"{args.task}, lr {args.lr}, seeds {args.sl_tc_min}/"
          f"{args.sl_tc_max} {args.sl_tc_seed_tech}, knn {args.sl_tc_knn} "
          f"{args.sl_tc_knn_mode}, crf_impl {args.crf_impl} M "
          f"{args.crf_n_landmarks}, im_rec {args.im_rec}, switch at epoch "
          f"{args.sl_tc_epoch_switch_to_sl}", flush=True)
    check(args.sl_tc_knn_mode == "before-after" and args.crf_tc_lambda
          == 2e-9 and args.batch_size == 32, "path H: the yaml was not read")
    rep = report_trainer("path H", out, PATH_H_EPOCHS)
    steps = rep["steps"]
    train = out["records"]["train"]
    for r in train:
        print(f"[path H epoch {r['epoch']}] seed source {r['seed_source']}"
              f" (student snapshot of epoch {r['student_epoch']}, "
              f"{r['student_reloads']} reloads), median step "
              f"{r['median_step_ms']:.2f} ms, data wait "
              f"{r['data_wait_ms_per_step']:.2f} ms/step; terms " + ", ".join(
                  f"{k} {v:.6g}" for k, v in r["terms"].items()), flush=True)
    sources = [r["seed_source"] for r in train]
    check(sources == ["batch"] + ["student"] * (PATH_H_EPOCHS - 1),
          f"path H: seed sources {sources}")
    reloads = sum(r["student_reloads"] for r in train)
    check(1 <= reloads <= PATH_H_EPOCHS - 1, f"path H: {reloads} reloads")
    check("img_reconstruction" in train[0]["terms"],
          "path H: no image reconstruction term")
    student_steps = steps - train[0]["steps"]
    check(len(roi_ms) == student_steps, f"path H: roi_batch ran "
          f"{len(roi_ms)} times in {student_steps} student steps")
    knm = launches["knm_build"]["kernel"]
    print(f"[path H] {reloads} student reloads; roi_batch (ROI_LARGEST, "
          f"B=32) in the student steps median "
          f"{statistics.median(roi_ms):.2f} ms (min {min(roi_ms):.2f}, max "
          f"{max(roi_ms):.2f}); knm_build {knm} launches in {steps} steps; "
          f"{launches}; cli/train.main {wall_s:.2f} s", flush=True)
    check(knm == 2 * steps, f"path H: build_knm launched {knm} times in "
          f"{steps} steps (K_nm + K_mm each)")
    check(launches["bilateral_exact"]["kernel"] == 0,
          "path H: the exact filter ran")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path H: a plain version ran")
    return {"wall_s": wall_s, "launches": launches, "steps": steps,
            "seed_sources": sources, "student_reloads": reloads,
            "roi_batch_ms": roi_ms, "train": train,
            "eval": out["records"]["eval"], "test_best_loc": rep["best"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# ----------------------------------------------------- path I: F_CL
def path_i_flags(root: str, store: str, outd: str) -> list:
    """The F_CL (F-CAM) task with every one of its losses and image
    reconstruction, the exact CRF, over the stand-in store (its seeds:
    the TCAM seeder's defaults, as the JAX step draws them)."""
    return common_flags(root) + [
        "--task", "F_CL", "--arch", "UnetFCAM", "--batch_size", "32",
        "--eval_batch_size", "32", "--max_epochs", str(PATH_I_EPOCHS),
        "--lr", "0.01", "--freeze_cl", "true", "--sl_fc", "true",
        "--crf_fc", "true", "--entropy_fc", "true", "--max_sizepos_fc",
        "true", "--im_rec", "true", "--crf_impl", "exact",
        "--checkpoint_save", "0", "--std_cams_folder", store, "--outd",
        outd, "--exp_id", "i"]


def phase_f_cl(seed: int, data: dict) -> dict:
    """Path I: cli/train.main with path_i_flags (counts reset just
    before; kernel 1 once a step), then cli/evaluate.main on its
    best-localization snapshot against the trainer's test pass."""
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
    from tcam_wsol_video_tpu_torch.cli import train as cli_train

    root = data["root"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = cli_train.main(path_i_flags(root, os.path.join(root, "cams"),
                                      os.path.join(root, "exps_i")))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    rep = report_trainer("path I", out, PATH_I_EPOCHS)
    steps = rep["steps"]
    train = out["records"]["train"]
    names = {"img_reconstruction", "self_learning_fcams",
             "con_ran_field_fcams", "entropy_fcams",
             "max_size_positive_fcams"}
    for r in train:
        print(f"[path I epoch {r['epoch']}] terms " + ", ".join(
            f"{k} {v:.6g}" for k, v in r["terms"].items()), flush=True)
        check(set(r["terms"]) == names and all(
            np.isfinite(v) for v in r["terms"].values()),
              f"path I: loss terms {r['terms']}")
    k = launches["bilateral_exact"]["kernel"]
    print(f"[path I launches] bilateral_exact {k} in {steps} steps; "
          f"{launches}; cli/train.main {wall_s:.2f} s", flush=True)
    check(k == steps, f"path I: the exact CRF kernel launched {k} times in "
          f"{steps} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path I: a plain version ran")

    t0 = time.perf_counter()
    ev = cli_eval.main(common_flags(root) + [
        "--task", "F_CL", "--arch", "UnetFCAM", "--im_rec", "true",
        "--eval_batch_size", "32", "--exp_dir", out["outd"], "--split",
        "test"])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    want = rep["best"]
    gaps = {s: abs(ev[f"maxboxacc_{s}"] - want[f"maxboxacc_{s}"])
            for s in (30, 50, 70)}
    share = 100.0 / 320
    print(_eval_line("path I evaluate test best_localization",
                     {**ev, **ev["timing"]})
          + "; |evaluate - trainer| at IoU 30/50/70 "
          + "/".join(f"{g:.4f}" for g in gaps.values())
          + f" (tol {share:.4f}, one image); cli/evaluate.main {ev_s:.2f} s",
          flush=True)
    check(ev["n_images"] == 320 and max(gaps.values()) <= share,
          f"path I: evaluate is {gaps} off the trainer's test pass")
    return {"wall_s": wall_s, "evaluate_s": ev_s, "launches": launches,
            "steps": steps, "train": train, "eval": out["records"]["eval"],
            "test_best_loc": want, "evaluate": dict(ev),
            "evaluate_gap": gaps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# --------------------------------------------------- path M: the C_BOX task
PATH_M_EPOCHS = 2
CBOX_YAML = os.path.join(ROOT, "config_yaml", "ytov1_cbox.yaml")
CBOX_TERMS = {"area_box", "cl_scoring", "seed_cbox", "box_bounds"}


def path_m_flags(root: str, store: str, s1_outd: str, outd: str) -> list:
    """config_yaml/ytov1_cbox.yaml (DenseBoxNet on ResNet-50, every C_BOX
    loss, the 65 / 60 blur, 10 seeds, size_data priors) on the synthetic
    set at bs 32 / 224 px for PATH_M_EPOCHS epochs, over the CAM store
    `store` and the stage-1 folder `s1_outd` (the encoder, and the frozen
    classifier)."""
    return common_flags(root) + [
        "--config", CBOX_YAML, "--batch_size", "32", "--eval_batch_size",
        "32", "--max_epochs", str(PATH_M_EPOCHS), "--checkpoint_save", "0",
        "--std_cams_folder", store, "--folder_pre_trained_cl", s1_outd,
        "--outd", outd, "--exp_id", "m"]


# path M's step held against the CPU (fp32, TF32 off): each loss term
# within CBOX_TERM_RTOL of the CPU's, the box head's update within
# CBOX_UPDATE_RTOL of its largest entry; the eval step's boxes within
# CBOX_BOX_ATOL pixels, its logits within CBOX_TERM_RTOL of their largest
CBOX_TERM_RTOL = 1e-3
CBOX_UPDATE_RTOL = 1e-2
CBOX_BOX_ATOL = 1e-2
# the box head's bias of the held model, (x1, y1, x2, y2) in pixels (x on
# the height axis): a valid box of area share ~0.5 at 224 px, above every
# class's size prior, so that every C_BOX loss is live; its weight is
# scaled by CBOX_HOLD_WEIGHT, so that the boxes vary by a few pixels
CBOX_HOLD_BOX = (40.0, 32.0, 184.0, 192.0)
CBOX_HOLD_WEIGHT = 0.1


def phase_cbox_hold(seed: int, args, s1_outd: str) -> dict:
    """Path M's parts at its own shapes: one C_BOX train step and one eval
    step of DenseBoxNet (path E's stage-1 encoder, a box head that gives
    valid boxes) with path M's frozen classifier on path M's first train
    batch, on the card and on the CPU from the same state and the same
    injected noise, fp32 with TF32 off; then, at path M's compute dtype
    and TF32 setting, the Gaussian blur and one classifier forward of the
    step timed with CUDA events."""
    import copy

    from tcam_wsol_video_tpu_torch.cams.seeding import \
        cbox_seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.cli.train import (
        build_data, load_pretrained_classifier_weights,
        load_seeder_classifier)
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.data.folds import build_size_priors
    from tcam_wsol_video_tpu_torch.engine.cbox_steps import (
        make_cbox_eval_step, make_cbox_train_step)
    from tcam_wsol_video_tpu_torch.engine.lr import build_lr_fn
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.losses.build import get_loss
    from tcam_wsol_video_tpu_torch.models.factory import (
        DTYPES, create_model_from_args)
    from tcam_wsol_video_tpu_torch.ops.box_stats import gaussian_blur

    fargs = args.replace(compute_dtype="float32",
                         eval_compute_dtype="float32")
    kc = KeyChain(seed)
    fargs, train_pipe, eval_pipes = build_data(fargs, kc, "cuda")
    batch = {k: v for k, v in next(iter(train_pipe.epoch(0))).items()
             if k != "image_id"}
    b, crop = batch["image"].shape[0], fargs.crop_size
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model_from_args(fargs, device="cuda")
    load_pretrained_classifier_weights(fargs, model)
    with torch.no_grad():
        model.box_head.weight.mul_(CBOX_HOLD_WEIGHT)
        model.box_head.bias.copy_(torch.tensor(CBOX_HOLD_BOX))
    classifier, _ = load_seeder_classifier(fargs, kc, "cuda")
    priors = build_size_priors(eval_pipes[constants.VALIDSET][0].md, crop,
                               fargs.num_classes)["min_s"]
    rng = np.random.default_rng(seed)
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (b, 2, crop * crop))
    noise = {"normal": rng.standard_normal(b),
             "gumbel": -np.log(-np.log(u)),
             "z": rng.uniform(fargs.cb_seed_bg_low_z, fargs.cb_seed_bg_up_z,
                              b)}
    noise = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in noise.items()}

    def run(dev):
        m = copy.deepcopy(model).to(dev)
        cls = copy.deepcopy(classifier).to(dev)
        bt = {k: v.to(dev) for k, v in batch.items()}
        boxes, valid, logits = make_cbox_eval_step(m, cls, fargs)(
            bt["image"])
        ml = get_loss(fargs)
        state = TrainState(m, build_optimizer(fargs, m,
                                              build_lr_fn(fargs)(0)),
                           elb_t=fargs.elb_init_t)
        before = {k: v.detach().clone()
                  for k, v in m.box_head.state_dict().items()}
        met = make_cbox_train_step(ml, fargs, cbox_seeder_cfg_from_args(
            fargs), cls, priors)(
                state, bt, ml.switches(0),
                noise={k: v.to(dev) for k, v in noise.items()})
        return {"boxes": boxes.cpu(), "valid": valid.cpu(),
                "logits": logits.float().cpu(),
                "terms": {k: float(met[k]) for k in CBOX_TERMS},
                "valid_boxes": int(met["valid_boxes"]),
                "update": {k: (v.detach() - before[k]).cpu()
                           for k, v in m.box_head.state_dict().items()}}

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = run("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    errs = {"box_px": float((card["boxes"] - cpu["boxes"]).abs().max()),
            "logits": float((card["logits"] - cpu["logits"]).abs().max()
                            / cpu["logits"].abs().max())}
    for k in CBOX_TERMS:
        errs[k] = abs(card["terms"][k] - cpu["terms"][k]) / abs(
            cpu["terms"][k])
    for k, v in cpu["update"].items():
        errs[f"box_head.{k}"] = float(
            (card["update"][k] - v).abs().max() / v.abs().max())
    print(f"[path M hold] one step of {b} frames at {crop} px, fp32 (TF32 "
          f"off), card vs CPU: valid boxes {card['valid_boxes']} / "
          f"{cpu['valid_boxes']}; terms card "
          + ", ".join(f"{k} {card['terms'][k]:.8g}" for k in sorted(
              CBOX_TERMS)) + "; CPU "
          + ", ".join(f"{k} {cpu['terms'][k]:.8g}" for k in sorted(
              CBOX_TERMS)) + "; errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol: terms and logits {CBOX_TERM_RTOL}, box head update "
          f"{CBOX_UPDATE_RTOL}, boxes {CBOX_BOX_ATOL} px); CPU side "
          f"{cpu_s:.2f} s", flush=True)
    check(card["valid_boxes"] == cpu["valid_boxes"] == b
          and bool(card["valid"].all()) and bool(cpu["valid"].all()),
          f"path M hold: valid boxes card {card['valid_boxes']}, CPU "
          f"{cpu['valid_boxes']} of {b}")
    check(all(np.isfinite(cpu["terms"][k]) and cpu["terms"][k] != 0.0
              for k in CBOX_TERMS),
          f"path M hold: a loss term is not live: {cpu['terms']}")
    check(all(v.abs().max() > 0 for v in cpu["update"].values()),
          "path M hold: the box head did not move")
    check(errs["box_px"] <= CBOX_BOX_ATOL
          and errs["logits"] <= CBOX_TERM_RTOL
          and all(errs[k] <= CBOX_TERM_RTOL for k in CBOX_TERMS)
          and all(v <= CBOX_UPDATE_RTOL for k, v in errs.items()
                  if k.startswith("box_head.")),
          f"path M hold: the card is off the CPU: {errs}")

    # the step's parts at path M's own dtype and TF32 setting
    dtype = DTYPES[args.compute_dtype]
    images = batch["image"]
    blur_ms = cuda_call_ms(lambda: gaussian_blur(
        images, args.cb_cl_score_blur_ksize, args.cb_cl_score_blur_sigma),
        reps=10)
    composite = images.clone().requires_grad_(True)
    classify_ms = cuda_call_ms(
        lambda: classifier(composite, dtype)["cl_logits"], reps=10)
    print(f"[path M parts] at {args.compute_dtype}, {b} x {crop} px: "
          f"Gaussian blur {args.cb_cl_score_blur_ksize} / "
          f"{args.cb_cl_score_blur_sigma} median "
          f"{statistics.median(blur_ms):.3f} ms, one frozen-classifier "
          f"forward (input with gradient) median "
          f"{statistics.median(classify_ms):.3f} ms (3 a step), CUDA "
          f"events, 10 calls each", flush=True)
    return {"terms_card": card["terms"], "terms_cpu": cpu["terms"],
            "valid_boxes": card["valid_boxes"], "errors": errs,
            "cpu_s": cpu_s, "blur_ms": blur_ms, "classify_ms": classify_ms}


def phase_cbox(seed: int, data: dict, s1_outd: str) -> dict:
    """Path M: cli/train.main with path_m_flags over path E's dumped CAM
    store and stage-1 folder (counts reset just before; no kernel may
    launch: C_BOX has no CRF), then cli/evaluate.main on its
    best-localization snapshot against the trainer's test pass."""
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
    from tcam_wsol_video_tpu_torch.cli import train as cli_train

    root = data["root"]
    store = os.path.join(root, "cam_store")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with conv_weight_dtypes() as seen:
        out = cli_train.main(path_m_flags(root, store, s1_outd,
                                          os.path.join(root, "exps_m")))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    args = out["args"]
    print(f"[path M] --config {os.path.relpath(CBOX_YAML, ROOT)}: task "
          f"{args.task}, arch {args.arch} on {args.encoder_name}, blur "
          f"{args.cb_cl_score_blur_ksize} / {args.cb_cl_score_blur_sigma}, "
          f"cb_seed_n {args.cb_seed_n}, min size "
          f"{args.cb_pp_box_min_size_type}; frozen classifier from the "
          f"stage-1 snapshot at step {out['seeder_step']}", flush=True)
    check(args.task == "C_BOX" and args.arch == "DenseBoxNet"
          and args.encoder_name == "resnet50" and args.batch_size == 32
          and args.crop_size == 224 and args.cb_cl_score_blur_ksize == 65
          and args.cb_seed_n == 10, "path M: not the recipe's C_BOX at "
          f"bs 32 / 224 px: {args.task} {args.arch} {args.encoder_name} bs "
          f"{args.batch_size} crop {args.crop_size} blur "
          f"{args.cb_cl_score_blur_ksize} seeds {args.cb_seed_n}")
    check(out["seeder_step"] is not None and out["seeder_step"] > 0,
          f"path M: the frozen classifier is not a trained stage-1 snapshot "
          f"(step {out['seeder_step']})")
    convs = check_conv_dtypes("path M", seen, {"bfloat16", "float32"})
    rep = report_trainer("path M", out, PATH_M_EPOCHS)
    steps = rep["steps"]
    train = out["records"]["train"]
    for r in train:
        print(f"[path M epoch {r['epoch']}] valid boxes "
              f"{100 * r['valid_box_share']:.2f}% of {r['n']} frames; terms "
              + ", ".join(f"{k} {v:.6g}" for k, v in r["terms"].items()),
              flush=True)
        check(set(r["terms"]) == CBOX_TERMS and all(
            np.isfinite(v) for v in r["terms"].values()),
              f"path M: loss terms {r['terms']}")
        check(0.0 <= r["valid_box_share"] <= 1.0,
              f"path M: valid-box share {r['valid_box_share']}")
    print(f"[path M launches] {launches}; cli/train.main {wall_s:.2f} s, "
          f"peak {peak:.2f} GiB", flush=True)
    check(all(c["kernel"] == 0 and c["plain"] == 0
              for c in launches.values()),
          f"path M: a CRF kernel or plain version ran: {launches}")

    t0 = time.perf_counter()
    with conv_weight_dtypes() as seen:
        ev = cli_eval.main(common_flags(root) + [
            "--config", CBOX_YAML, "--eval_batch_size", "32",
            "--folder_pre_trained_cl", s1_outd, "--exp_dir", out["outd"],
            "--split", "test"])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    check_conv_dtypes("path M evaluate", seen, {"bfloat16", "float32"})
    want = rep["best"]
    gaps = {s: abs(ev[f"maxboxacc_{s}"] - want[f"maxboxacc_{s}"])
            for s in (30, 50, 70)}
    share = 100.0 / 320
    print(f"[path M test best_localization] MaxBoxAcc 30/50/70 "
          + "/".join(f"{want[f'maxboxacc_{s}']:.2f}" for s in (30, 50, 70))
          + f", classification {want['classification']:.2f}; evaluate "
          + "/".join(f"{ev[f'maxboxacc_{s}']:.2f}" for s in (30, 50, 70))
          + ", |evaluate - trainer| "
          + "/".join(f"{g:.4f}" for g in gaps.values())
          + f" (tol {share:.4f}, one image); {ev['timing']['images_per_s']:.1f}"
          f" images/s; cli/evaluate.main {ev_s:.2f} s", flush=True)
    check(ev["n_images"] == 320 and ev["timing"]["sweep"] == "bbox"
          and max(gaps.values()) <= share,
          f"path M: evaluate is {gaps} off the trainer's test pass")
    check(read_counts() == launches, "path M: evaluate launched a kernel")
    if max(want[f"maxboxacc_{s}"] for s in (30, 50, 70)) == 0.0:
        print("[path M] every test box of the 2-epoch model is invalid or "
              "missed: MaxBoxAcc and the evaluate gap compare 0 with 0; "
              "the hold below holds the boxes, losses and update",
              flush=True)
    hold = phase_cbox_hold(seed, args, s1_outd)
    return {"wall_s": wall_s, "evaluate_s": ev_s, "launches": launches,
            "steps": steps, "train": train, "eval": out["records"]["eval"],
            "test_best_loc": want, "evaluate": dict(ev),
            "evaluate_gap": gaps, "conv_dtypes": convs, "hold": hold,
            "blur_ms": hold["blur_ms"], "classify_ms": hold["classify_ms"],
            "classifier_seeder_step": out["seeder_step"],
            "peak_mem_gib": peak}


# ------------------- path J: stage 1 on the other encoders and heads
# (encoder, pooling head, CAM method): each new encoder, and each head
# that builds maps, once
PATH_J_PAIRS = (("vgg16", "GAP", "GAP"),
                ("inceptionv3", "WildCatCLHead", "WildCat"),
                ("resnet101", "LogSumExpPool", "LogSumExpPool"),
                ("resnet50", "MaxPool", "MaxPool"))
PATH_J_EPOCHS = 1
# the snapshot that cli/evaluate.main scores against the trainer
PATH_J_EVALUATED = "resnet101"
PATH_K_EPOCHS = 1


def path_j_flags(root: str, outd: str, encoder: str, pooling: str,
                 method: str) -> list:
    """The stage-1 command of path E on another encoder and head,
    PATH_J_EPOCHS epochs."""
    return common_flags(root) + [
        "--task", "STD_CL", "--encoder_name", encoder, "--spatial_pooling",
        pooling, "--method", method, "--batch_size", "32",
        "--eval_batch_size", "32", "--max_epochs", str(PATH_J_EPOCHS),
        "--lr", "0.001", "--checkpoint_save", "0", "--outd", outd,
        "--exp_id", "j"]


def phase_stage1_encoders(seed: int, data: dict) -> dict:
    """Path J: cli/train.main STD_CL on each pair of PATH_J_PAIRS (counts
    reset just before: no kernel runs in stage 1), cli/evaluate.main on
    the PATH_J_EVALUATED snapshot against the trainer's test pass, and
    cli/dump_cams.main from the VGG16/GAP snapshot (the built-in route)
    into the store that path K reads."""
    from tcam_wsol_video_tpu_torch.cli import dump_cams as cli_dump
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.data.cam_store import CamStore

    root = data["root"]
    outd = os.path.join(root, "exps_j")
    reset_counts()
    runs = {}
    for enc, pool, method in PATH_J_PAIRS:
        tag = f"path J {enc}/{pool}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = cli_train.main(path_j_flags(root, outd, enc, pool, method))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        rep = report_trainer(tag, out, PATH_J_EPOCHS)
        tr = out["records"]["train"]
        runs[enc] = {
            "pooling": pool, "method": method, "wall_s": wall_s,
            "outd": out["outd"], "train": tr,
            "median_step_ms": [r["median_step_ms"] for r in tr],
            "data_wait_ms_per_step": [r["data_wait_ms_per_step"]
                                      for r in tr],
            "test_best_loc": rep["best"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"[{tag}] cli/train.main {wall_s:.2f} s, peak "
              f"{runs[enc]['peak_mem_gib']:.2f} GiB", flush=True)
    launches = read_counts()
    check(all(c["kernel"] == 0 and c["plain"] == 0
              for c in launches.values()),
          f"path J: stage 1 launched a CRF filter: {launches}")

    enc = PATH_J_EVALUATED
    r = runs[enc]
    t0 = time.perf_counter()
    ev = cli_eval.main(common_flags(root) + [
        "--task", "STD_CL", "--encoder_name", enc, "--spatial_pooling",
        r["pooling"], "--method", r["method"], "--eval_batch_size", "32",
        "--exp_dir", r["outd"], "--split", "test"])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    want = r["test_best_loc"]
    gaps = {s: abs(ev[f"maxboxacc_{s}"] - want[f"maxboxacc_{s}"])
            for s in (30, 50, 70)}
    share = 100.0 / 320
    print(_eval_line(f"path J {enc} evaluate test best_localization",
                     {**ev, **ev["timing"]})
          + "; |evaluate - trainer| at IoU 30/50/70 "
          + "/".join(f"{g:.4f}" for g in gaps.values())
          + f" (tol {share:.4f}, one image); cli/evaluate.main {ev_s:.2f} s",
          flush=True)
    check(ev["n_images"] == 320 and max(gaps.values()) <= share,
          f"path J: evaluate is {gaps} off the trainer's test pass")

    store_dir = os.path.join(root, "cam_store_j")
    dump = cli_dump.main(common_flags(root) + [
        "--task", "STD_CL", "--encoder_name", "vgg16", "--spatial_pooling",
        "GAP", "--method", "GAP", "--exp_dir", runs["vgg16"]["outd"],
        "--out", store_dir])
    torch.cuda.synchronize()
    store = CamStore(store_dir)
    th = store.thresholds or {}
    cams = [store.load_cam(f) for f in th]
    print(f"[path J dump] vgg16/GAP built-in route: {dump['n_frames']} "
          f"frames of the best_localization snapshot (step {dump['step']}) "
          f"in {dump['seconds']:.2f} s, {dump['frames_per_s']:.1f} "
          f"frames/s; CAMs {cams[0].shape}, {len(th)} thresholds in "
          f"[{min(th.values()):.4f}, {max(th.values()):.4f}]", flush=True)
    check(dump["n_frames"] == len(th) == 640
          and all(c.shape == (28, 28) and 0.0 <= c.min() and c.max() <= 1.0
                  for c in cams)
          and sum(float(c.max()) > 0.0 for c in cams) > 0,
          "path J: the built-in dump's store")
    return {"runs": runs, "launches": launches, "evaluated": enc,
            "evaluate": dict(ev), "evaluate_gap": gaps,
            "evaluate_s": ev_s, "store": store_dir,
            "dump": {k: v for k, v in dump.items() if k != "store"}}


def phase_tcam_vgg16(seed: int, data: dict, pj: dict) -> dict:
    """Path K: cli/train.main TCAM (path D's flags, exact CRF) on VGG16
    over path J's built-in store, from its VGG16/GAP stage-1 folder,
    PATH_K_EPOCHS epochs, counts reset just before: kernel 1 once a step
    under the decoder with the center block."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
    from tcam_wsol_video_tpu_torch.core import constants

    root = data["root"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = cli_train.main(path_d_flags(
        root, pj["store"], os.path.join(root, "exps_k"),
        pretrained=pj["runs"]["vgg16"]["outd"], epochs=PATH_K_EPOCHS,
        exp_id="k") + ["--encoder_name", "vgg16", "--spatial_pooling",
                       "GAP", "--method", "GAP"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    rep = report_trainer("path K", out, PATH_K_EPOCHS)
    steps = rep["steps"]
    k = launches["bilateral_exact"]["kernel"]
    _, snap = ckpt.load_best_model(os.path.join(out["outd"],
                                                constants.BEST_LOC))
    center = sorted(n for n in snap["components"]["decoder"]
                    if n.startswith("center."))
    print(f"[path K launches] bilateral_exact {k} in {steps} steps; "
          f"{launches}; decoder center block {len(center)} tensors; "
          f"cli/train.main {wall_s:.2f} s", flush=True)
    check(k == steps, f"path K: the exact CRF kernel launched {k} times in "
          f"{steps} steps")
    check(all(c["plain"] == 0 for c in launches.values()),
          "path K: a plain version ran")
    check(len(center) > 0, "path K: the VGG decoder has no center block")
    tr = out["records"]["train"]
    return {"wall_s": wall_s, "launches": launches, "steps": steps,
            "train": tr, "test_best_loc": rep["best"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_unet_encoders(seed: int, steps: int = 2) -> dict:
    """Path A's step (exact CRF, bs 32 / 224 px, bf16) on UnetTCAM with
    the InceptionV3 and the ResNet-101 encoder: `steps` steps each (the
    first warms up), counts reset just before, kernel 1 once a step."""
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

    out = {}
    for enc in ("inceptionv3", "resnet101"):
        tag = f"UnetTCAM {enc}"
        (args, model, opt, state, train_step, _, batch, gen,
         switches) = build_main_path(seed, encoder=enc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with CrfTimer(bilateral) as timer:
            records = run_steps(train_step, state, batch, switches, gen,
                                steps, timer, tag)
        launches = read_counts()
        k = launches["bilateral_exact"]["kernel"]
        check(k == steps, f"{tag}: the exact CRF kernel launched {k} times "
              f"in {steps} steps")
        check(all(c["plain"] == 0 for c in launches.values()),
              f"{tag}: a plain version ran")
        out[enc] = {"steps": records, "launches": launches,
                    "step_ms": records[-1]["step_ms"],
                    "crf_ms": records[-1]["crf_ms"],
                    "peak_mem_gib": torch.cuda.max_memory_allocated()
                    / 2 ** 30}
        print(f"[{tag}] step {out[enc]['step_ms']:.2f} ms (after "
              f"{steps - 1} warm-up), kernel 1 {out[enc]['crf_ms']:.2f} ms "
              f"of it, peak {out[enc]['peak_mem_gib']:.2f} GiB", flush=True)
        del state, model, opt, batch
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the CAM-method phase
# the eval step's normalized maps, card (TF32 off) against the CPU on the
# same weights, inputs and noise: fp32 summed in other orders through ~50
# layers, min-max normalized
CAM_METHOD_ATOL = 1e-3
# (images, samples) of the ScoreCAM family: 2048 masked forwards an image
# per sample at full width; JAX's tests/test_scorecam_e2e.py reduction
SCORE_REDUCTION = {"ScoreCAM": (2, 1), "SSCAM": (1, 2), "ISCAM": (1, 2)}
# the CPU holds the ScoreCAM family on the same frames resized to this
# crop (the same model, images, samples and noise draws; every 32-channel
# chunk of the 2048): at 224 px the CPU would need ~12000 ResNet-50
# forwards (~470 TFLOP)
SCORE_HOLD_CROP = 32
# the other methods: the card runs the batch of 32, the CPU holds its
# first CAM_HOLD_IMAGES maps (the eval step treats each image alone: BN
# in inference mode, one gradient of a sum of per-image logits)
CAM_HOLD_IMAGES = 8


def phase_cam_methods(seed: int, data: dict, s1_outd: str) -> dict:
    """Every WGAP CAM method's STD_CL eval step on one batch of path D's
    test frames, with the stage-1 ResNet-50/WGAP model of path E's
    best-localization snapshot: timed on the card, held against the same
    eval step on the CPU (TF32 off; the noise of SmoothGradCAM++ and SSCAM
    drawn once and injected)."""
    import copy

    from tcam_wsol_video_tpu_torch.cli.train import (eval_dataset,
                                                     resolve_metadata_root)
    from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.core.config import (finalize,
                                                       stage1_cam_recipe)
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
    from tcam_wsol_video_tpu_torch.engine.steps import make_cam_eval_step
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args
    from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear

    root = data["root"]
    base = resolve_metadata_root(stage1_cam_recipe(
        crop_size=224, resize_size=256, data_root=root,
        metadata_root=os.path.join(root, "folds"), seed=seed))
    kc = KeyChain(seed)
    pipe = DataPipeline(eval_dataset(base, kc, constants.TESTSET), 32, kc,
                        shuffle=False, device="cuda")
    batch = next(iter(pipe.epoch(0)))
    images, labels = batch["image"], batch["label"]
    model = create_model_from_args(base, device="cuda")
    step, payload = ckpt.load_best_model(os.path.join(s1_outd,
                                                      constants.BEST_LOC))
    ckpt.load_components(model, payload["components"])
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(seed)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    try:
        for method in (m for m in constants.CAM_METHODS
                       if constants.METHOD_2_POOLINGHEAD[m]
                       == constants.WGAP):
            n, samples = SCORE_REDUCTION.get(method, (images.shape[0], 1))
            args = finalize(base.replace(method=method))
            args.sscam_num_samples = args.iscam_num_samples = samples
            x, y = images[:n], labels[:n]

            def noise_for(size):
                if method == constants.METHOD_SMOOTHGRADCAMPP:
                    k, std = 4, 0.3
                elif method == constants.METHOD_SSCAM:
                    k, std = samples, 2.0
                else:
                    return None
                return torch.from_numpy(std * rng.standard_normal(
                    (k, n, size, size, 3)).astype(np.float32))

            noise = noise_for(224)
            step_fn = make_cam_eval_step(model, args)
            dev_noise = None if noise is None else noise.cuda()
            score = method in SCORE_REDUCTION
            cams = []
            ms = cuda_call_ms(lambda: cams.append(step_fn(
                x, targets=y, noise=dev_noise)[0]),
                reps=1 if score else 3, warmup=0 if score else 1)
            cam = cams[-1]
            check(tuple(cam.shape) == (n, 224, 224)
                  and bool(torch.isfinite(cam).all()) and cam.min() >= 0.0
                  and cam.max() <= 1.0, f"CAM method {method}: the map")
            hold = {"crop": 224}
            if score:
                hc = SCORE_HOLD_CROP
                xs = resize_bilinear(x, (hc, hc), align_corners=False)
                hargs = args.replace(crop_size=hc)
                hargs.sscam_num_samples = hargs.iscam_num_samples = samples
                hnoise = noise_for(hc)
                card, _ = make_cam_eval_step(model, hargs)(
                    xs, targets=y, noise=None if hnoise is None
                    else hnoise.cuda())
                want, _ = make_cam_eval_step(cpu_model, hargs)(
                    xs.cpu(), targets=y.cpu(), noise=hnoise)
                hold = {"crop": hc}
            else:
                k = CAM_HOLD_IMAGES
                card = cam[:k]
                want, _ = make_cam_eval_step(cpu_model, args)(
                    x[:k].cpu(), targets=y[:k].cpu(),
                    noise=None if noise is None else noise[:, :k])
                hold["images"] = k
            err = float((card.cpu() - want).abs().max())
            rows[method] = {"images": n, "samples": samples,
                            "ms": statistics.median(ms),
                            "ms_per_image": statistics.median(ms) / n,
                            "max_abs_err": err, "hold_crop": hold["crop"],
                            "hold_images": hold.get("images", n)}
            print(f"[cam methods] {method}: {n} images x {samples} "
                  f"sample(s), {rows[method]['ms_per_image']:.3f} ms/image "
                  f"on the card (TF32 off); against the CPU on "
                  f"{rows[method]['hold_images']} images at {hold['crop']} "
                  f"px: max |diff| {err:.3e} (tol {CAM_METHOD_ATOL})",
                  flush=True)
            check(err <= CAM_METHOD_ATOL, f"CAM method {method}: the card "
                  f"is {err:.3e} off the CPU")
            check(bool(torch.isfinite(card).all()) and card.min() >= 0.0
                  and card.max() <= 1.0, f"CAM method {method}: map range")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return {"snapshot_step": step, "methods": rows}


# ------------------------------------------------- path N: several ranks
# two ranks against one at path A's fp32 step (TF32 off, cuDNN
# deterministic, 16 frames a rank against 32), 2 steps: the loss terms
# (relative), every parameter's update relative to the one-rank update's
# largest entry of its tensor (plus 4 ulp of the parameter) and the BN
# running statistics relative to their largest entry.  The bounds of
# PR 13's first run (1e-4, 1e-3, 1e-4) lay under the card's own fp32
# noise on this random-weight model: one rank against itself with another
# cuDNN algorithm choice (benchmark mode) differed by 9.2e-3 in the loss,
# 9.9e-2 in the updates and 7.4e-3 in the BN statistics (PERF.md, PR 13);
# these were written there before the next run.  Each run measures that
# floor again beside the gaps (mesh_floor).
MESH_LOSS_RTOL = 1e-3
MESH_DELTA_RTOL = 1e-1
MESH_BN_RTOL = 1e-2
MESH_STEPS = 2
MESH_WORLD = 2
# a rank that has not finished by then fails the phase (the group killed)
MESH_DEADLINE_S = 600


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def exact_fp32(benchmark: bool = False):
    """TF32 off and cuDNN deterministic within the block (benchmark: cuDNN
    picks its algorithms by timing them instead, another valid choice)."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = not benchmark, benchmark
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def mesh_steps(seed: int, mesh=None, benchmark: bool = False) -> dict:
    """Path A's recipe at fp32 from the seed's weights: MESH_STEPS steps on
    the rank's rows of its 32-frame batch (all of them without a mesh), the
    seeder's noise drawn from the seeded generator (each rank its rows of
    the global draw).  Returns the global losses, step ms, the gradient
    all-reduce ms, kernel 1's launches, the peak memory and the state."""
    from tcam_wsol_video_tpu_torch.core.clock import SpanClock
    from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh

    with exact_fp32(benchmark):
        (args, model, opt, state, train_step, _, batch, gen,
         switches) = build_main_path(seed, dtype="float32", mesh=mesh)
        init = ({k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
                if mesh is None else None)
        b = args.batch_size
        lo, n = 0, b
        if mesh is not None:
            pmesh.broadcast_state(model, mesh)
            n = b // mesh.dp
            lo = mesh.d * n
            mesh.clock = SpanClock(torch.device("cuda"))
        local = {k: v[lo:lo + n] for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        steps = []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = train_step(state, local, switches, seed_weighted=True,
                             generator=gen)
            torch.cuda.synchronize()
            steps.append({**{k: float(v) for k, v in met.items()},
                          "step_ms": (time.perf_counter() - t0) * 1e3})
        launches = read_counts()
        comm = mesh.clock.millis() if mesh is not None else []
        if mesh is not None:
            mesh.clock = None
    return {"frames": n, "steps": steps, "allreduce_ms": comm,
            "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "init": init}


def _mesh_worker(rank: int, world: int, port: int, backend: str,
                 eval_argv: list, out_dir: str, q) -> None:
    """A rank of path N(b) and (c), in a spawned process: the group over
    `backend` (asked for explicitly), the two steps, then cli/evaluate.main
    on the rank's shard."""
    import hashlib
    import traceback
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
        from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh
        device = pmesh.maybe_init_distributed("cuda", backend=backend,
                                              timeout_s=300)
        mesh = pmesh.make_mesh(world, 1)
        run = mesh_steps(SEED, mesh)
        state = run.pop("state")
        run.pop("init")
        run["state_sha"] = {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                            for k, v in state.items()}
        if rank == 0:
            torch.save(state, os.path.join(out_dir, "rank0_state.pt"))
        del state
        torch.cuda.empty_cache()
        if eval_argv is not None:
            res = cli_evaluate.main(eval_argv + ["--mesh_dp", str(world)])
            run["evaluate"] = {k: v for k, v in res.items()
                               if isinstance(v, (int, float))}
        run["device"] = str(device)
        run["backend"] = mesh.backend
        pmesh.shutdown()
        q.put((rank, "ok", run))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


def _torchrun(module: str, argv: list, nproc: int, timeout: int):
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_addr=127.0.0.1",
           f"--master_port={_free_port()}", "-m", module, *argv]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        print(out.stderr[-6000:], file=sys.stderr, flush=True)
    check(out.returncode == 0, f"{module} under torch.distributed.run "
          f"--nproc_per_node {nproc} exited {out.returncode}")
    return out


def _counters(r: dict) -> dict:
    return {k: v for k, v in r.items()
            if k == "n_images" or k in ("classification", "localization")
            or k.startswith(("maxboxacc_", "top1_loc_", "top5_loc_"))}


def mesh_rank_runs(eval_argv) -> dict:
    """MESH_WORLD spawned ranks of _mesh_worker (one card each over NCCL,
    or all on the one card over gloo, asked for explicitly); eval_argv:
    cli/evaluate.main's flags (None: no evaluation).  A rank that fails or
    has not finished by MESH_DEADLINE_S fails the phase."""
    import multiprocessing
    import queue as queue_mod

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
    out_dir = os.path.join(ROOT, "build", "mesh_ranks")
    os.makedirs(out_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_worker, args=(
        r, MESH_WORLD, port, backend, eval_argv, out_dir, q))
        for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    runs, errors = {}, []
    try:
        while len(runs) + len(errors) < MESH_WORLD:
            left = MESH_DEADLINE_S - (time.perf_counter() - t0)
            try:
                rank, status, payload = q.get(timeout=max(1.0, left))
            except queue_mod.Empty:
                errors.append(f"ranks not done in {MESH_DEADLINE_S} s")
                break
            if status == "ok":
                runs[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    check(not errors, "path N(b): " + "\n".join(errors))
    check(all(p.exitcode == 0 for p in procs),
          f"path N: rank exit codes {[p.exitcode for p in procs]}")
    state = torch.load(os.path.join(out_dir, "rank0_state.pt"),
                       weights_only=True)
    shutil.rmtree(out_dir)
    return {"ranks": [runs[r] for r in range(MESH_WORLD)], "state": state,
            "cards": n_cards, "seconds": time.perf_counter() - t0}


def mesh_gaps(one: dict, two: list, state: dict) -> dict:
    """The ranks' gaps to one rank: each loss term's (relative, the counts
    equal), each parameter's update (its largest difference over the
    one-rank update's largest entry; `over` names those beyond
    MESH_DELTA_RTOL plus 4 ulp of the parameter) and the BN statistics'
    (relative to their largest entry)."""
    loss_err = {}
    for i in range(MESH_STEPS):
        for k, want in one["steps"][i].items():
            if k == "step_ms":
                continue
            for r in two:
                got = r["steps"][i][k]
                if k in ("n", "n_correct"):
                    check(got == want, f"path N(b) step {i}: {k} {got} != "
                          f"{want}")
                    continue
                err = abs(got - want) / max(abs(want), 1e-12)
                loss_err[k] = max(loss_err.get(k, 0.0), err)
    p0 = one["init"]
    delta_err, worst, bn_err, over = 0.0, "", 0.0, []
    for k, want in one["state"].items():
        got = state[k]
        if "running_" in k:
            bn_err = max(bn_err, float((got - want).abs().max())
                         / max(float(want.abs().max()), 1e-12))
            continue
        if not got.is_floating_point():
            check(torch.equal(got, want), f"path N(b): {k}")
            continue
        old = p0[k]
        d_want = want - old
        scale = float(d_want.abs().max())
        tol = (MESH_DELTA_RTOL * scale + 4 * float(
            torch.finfo(torch.float32).eps) * float(old.abs().max()))
        err = float(((got - old) - d_want).abs().max())
        if scale > 0 and err / scale > delta_err:
            delta_err, worst = err / scale, k
        if err > tol:
            over.append(k)
    return {"loss_rel": loss_err, "delta_rel": delta_err, "worst": worst,
            "bn_rel": bn_err, "over": over}


def phase_mesh(seed: int, data: dict, path_d: dict) -> dict:
    """Path N, several ranks (parallel/mesh.py):
    (a) cli/train.main under torch.distributed.run --nproc_per_node 1 (a
        world of 1 over NCCL) with path D's flags for 1 epoch: its
        first-step loss and its val counters before training against
        path D's (the same weights); then cli/evaluate.main the same way
        on its best-localization snapshot;
    (b) 2 ranks (one card each over NCCL, or both on the one card over
        gloo, asked for explicitly: NCCL refuses two ranks on one device)
        against one rank without a process group: path A's fp32 step, 16
        frames a rank against 32, for 2 steps: the losses, every parameter
        and the BN statistics within the MESH_* bounds, the two ranks'
        states bit-equal, kernel 1 once a step on each rank; beside them
        the card's own floor, one rank against itself under another cuDNN
        algorithm choice;
    (c) cli/evaluate.main on the 2 ranks over (a)'s snapshot: counters
        bit-equal to (a)'s world-1 evaluation."""
    root = data["root"]
    store = os.path.join(root, "cams")
    outd = os.path.join(root, "exps_n")
    # (a)
    t0 = time.perf_counter()
    flags = path_d_flags(root, store, outd, epochs=1, exp_id="n1")
    out = _torchrun("tcam_wsol_video_tpu_torch.cli.train", flags, 1, 900)
    train_s = time.perf_counter() - t0
    exp = os.path.join(outd, os.listdir(outd)[0], "n1")
    with open(os.path.join(exp, "performances.json")) as f:
        perf = json.load(f)
    with open(os.path.join(exp, "log.json")) as f:
        msgs = [json.loads(x).get("msg") for x in f]
    check(any(str(m).startswith("mesh: dp=1 mp=1 over nccl") for m in msgs),
          "path N(a): the world of 1 did not join over NCCL")
    rec = perf["records"]["train"][0]
    d_rec = path_d["train"][0]
    first = (rec["step_losses"][0], d_rec["step_losses"][0])
    first_rel = abs(first[0] - first[1]) / abs(first[1])
    val = (_counters(perf["records"]["eval"][0]),
           _counters(path_d["eval"][0]))
    print(f"[path N(a)] world 1 over NCCL: {rec['steps']} steps, median "
          f"step {rec['median_step_ms']:.2f} ms, gradient all-reduce "
          f"{rec['allreduce_ms_per_step']:.3f} ms/step (none at one rank), "
          f"first-step loss {first[0]:.6g} (path D {first[1]:.6g}, rel "
          f"{first_rel:.2e}); val before training "
          f"{'bit-equal to' if val[0] == val[1] else 'UNLIKE'} path D's; "
          f"cli/train.main {train_s:.1f} s", flush=True)
    check(first_rel <= 1e-3, "path N(a): first-step loss off path D's")
    check(val[0] == val[1], f"path N(a): val counters {val[0]} != path D's "
          f"{val[1]}")
    common = common_flags(root) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--eval_batch_size", "32",
        "--exp_dir", exp]
    t0 = time.perf_counter()
    ev = _torchrun("tcam_wsol_video_tpu_torch.cli.evaluate", common, 1, 600)
    eval_s = time.perf_counter() - t0
    world1 = json.loads([ln for ln in ev.stdout.splitlines()
                         if ln.startswith("{")][-1])
    print(f"[path N(a)] cli/evaluate.main (world 1): {world1['n_images']} "
          f"images, MaxBoxAcc@50 {world1['maxboxacc_50']:.2f}, "
          f"{eval_s:.1f} s", flush=True)
    check(world1["n_images"] == 320, "path N(a): evaluate image count")

    # (b) the reference first, in this process, and the card's own fp32
    # noise on it (another cuDNN algorithm choice); then the ranks
    one = mesh_steps(seed)
    other = mesh_steps(seed, benchmark=True)
    floor = mesh_gaps(one, [other], other.pop("state"))
    del other
    torch.cuda.empty_cache()
    runs = mesh_rank_runs(common)
    two = runs["ranks"]
    gaps = mesh_gaps(one, two, runs["state"])
    loss_err, delta_err, bn_err = (gaps["loss_rel"], gaps["delta_rel"],
                                   gaps["bn_rel"])
    check(two[0]["state_sha"] == two[1]["state_sha"],
          "path N(b): the two ranks' states differ")
    check(not gaps["over"], "path N(b): parameter updates over "
          f"{MESH_DELTA_RTOL} of their largest entry: {gaps['over'][:5]}")
    for k, e in loss_err.items():
        check(e <= MESH_LOSS_RTOL, f"path N(b): {k} rel {e:.3e} > "
              f"{MESH_LOSS_RTOL}")
    check(bn_err <= MESH_BN_RTOL, f"path N(b): BN statistics rel {bn_err}")
    for r in two:
        k = r["launches"]["bilateral_exact"]["kernel"]
        check(k == MESH_STEPS, f"path N(b): kernel 1 launched {k} times in "
              f"{MESH_STEPS} steps on {r['device']}")
        check(all(c["plain"] == 0 for c in r["launches"].values()),
              "path N(b): a plain version ran")
    n_cards, ranks_s = runs["cards"], runs["seconds"]
    print(f"[path N(b)] {MESH_WORLD} ranks over {two[0]['backend']} on "
          f"{n_cards} card(s) ({', '.join(r['device'] for r in two)}), "
          f"{two[0]['frames']} frames each, against one rank at "
          f"{one['frames']}: loss terms rel "
          + ", ".join(f"{k} {e:.2e}" for k, e in loss_err.items())
          + f" (bound {MESH_LOSS_RTOL}); parameter updates "
          f"{delta_err:.2e} of their largest entry ({gaps['worst']}; bound "
          f"{MESH_DELTA_RTOL}); BN statistics rel {bn_err:.2e} (bound "
          f"{MESH_BN_RTOL}); states bit-equal across ranks; the card's "
          f"floor (1 rank, cuDNN benchmark): loss "
          f"{max(floor['loss_rel'].values()):.2e}, updates "
          f"{floor['delta_rel']:.2e}, BN {floor['bn_rel']:.2e}", flush=True)
    for r in [one] + two:
        who = "1 rank" if r is one else f"rank on {r['device']}"
        print(f"[path N(b)] {who}: step ms " + "/".join(
            f"{s['step_ms']:.2f}" for s in r["steps"])
            + ", gradient all-reduce ms " + ("/".join(
                f"{m:.2f}" for m in r["allreduce_ms"]) or "none")
            + f", kernel 1 x{r['launches']['bilateral_exact']['kernel']}, "
            f"peak {r['peak_mem_gib']:.2f} GiB", flush=True)

    # (c)
    got = [_counters(r["evaluate"]) for r in two]
    want = _counters(world1)
    print(f"[path N(c)] cli/evaluate.main on {MESH_WORLD} ranks: "
          f"{got[0]['n_images']} images, MaxBoxAcc@50 "
          f"{got[0]['maxboxacc_50']:.2f}; counters "
          f"{'bit-equal to' if all(g == want for g in got) else 'UNLIKE'} "
          f"world 1's; the ranks' phase {ranks_s:.1f} s", flush=True)
    for g in got:
        check(g == want, f"path N(c): {g} != world 1's {want}")
    launches = sum(r["launches"]["bilateral_exact"]["kernel"] for r in two)
    return {"world1": {"train": perf["records"]["train"],
                       "first_step_rel": first_rel, "evaluate": world1,
                       "train_s": train_s, "eval_s": eval_s},
            "backend": two[0]["backend"], "cards": n_cards,
            "ranks": [{k: v for k, v in r.items() if k != "state_sha"}
                      for r in two],
            "one_rank": {k: v for k, v in one.items()
                         if k not in ("state", "init")},
            "loss_rel": loss_err, "delta_rel": delta_err, "bn_rel": bn_err,
            "worst": gaps["worst"],
            "floor": {k: v for k, v in floor.items() if k != "over"},
            "launches": launches, "ranks_s": ranks_s}


# ------------------------------------------- path O: the demo and visuals
# the JPEG bound of a demo frame (quality 95, 4:2:0 chroma as mp4v's
# yuv420p): PSNR of the luma against the overlay array, as
# tests/test_torch_viz.py holds libjpeg's frames
DEMO_LUMA_PSNR_DB = 40.0
PATH_O_EPOCHS = 1
PATH_O_VIDEOS = 10
# the files JAX's trainer hooks write (engine/trainer.py), each snapshot's
# test pass and the meters; .avi stands for JAX's demo .mp4
VISUAL_FILES = ("performances.pkl", "performances.txt", "performances.png",
                "progress/epoch_0000.png")


def read_avi_frames(path: str) -> tuple:
    """(the JPEG bytes of each `00dc` chunk of the movi list, the idx1
    entries) of a Motion-JPEG AVI."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI ",
          f"{path} is not a RIFF AVI")
    frames, n_index, pos = [], 0, 12
    while pos + 8 <= len(data):
        cc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if cc == b"LIST" and data[pos + 8:pos + 12] == b"movi":
            q, end = pos + 12, pos + 8 + size
            while q < end:
                (sz,) = struct.unpack("<I", data[q + 4:q + 8])
                if data[q:q + 4] == b"00dc":
                    frames.append(data[q + 8:q + 8 + sz])
                q += 8 + sz + (sz & 1)
        elif cc == b"idx1":
            n_index = size // 16
        pos += 8 + size + (size & 1)
    return frames, n_index


def luma_psnr(a: np.ndarray, b: np.ndarray) -> float:
    w = np.asarray([0.299, 0.587, 0.114])
    mse = (((a.astype(np.float64) - b.astype(np.float64)) @ w) ** 2).mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _checked_planner():
    """A FrameReusePlanner that records each frame's mean |delta| to its
    video's previous frame and checks that every reused row gets the last
    computed CAM of its video."""
    from tcam_wsol_video_tpu_torch.engine.temporal_reuse import \
        FrameReusePlanner

    class CheckedPlanner(FrameReusePlanner):
        made: list = []

        def __init__(self, threshold):
            super().__init__(threshold)
            self.diffs, self.prev, self.last = [], {}, {}
            self.reused_checked = 0
            CheckedPlanner.made.append(self)

        def plan(self, video_ids, raws):
            for vid, raw in zip(video_ids, raws):
                p = self.prev.get(vid)
                if p is not None:
                    self.diffs.append(float(np.mean(np.abs(
                        raw.astype(np.float32) - p.astype(np.float32)))))
                self.prev[vid] = raw
            return super().plan(video_ids, raws)

        def resolve_rows(self, video_ids, compute_rows, reuse_from,
                         computed_cams, out):
            super().resolve_rows(video_ids, compute_rows, reuse_from,
                                 computed_cams, out)
            row_to_j = {r: j for j, r in enumerate(compute_rows)}
            for i, src in enumerate(reuse_from):
                if src is None:
                    self.last[video_ids[i]] = computed_cams[row_to_j[i]]
                    continue
                check(np.array_equal(out[i], self.last[src]),
                      f"path O: a reused row of {src} is not its last "
                      "computed CAM")
                self.reused_checked += 1

    return CheckedPlanner


def run_demo(argv: list, planner_cls) -> dict:
    """cli/demo_video.main with the checked planner and build_demo_video
    recording each video's frames before it encodes them (nvJPEG)."""
    from tcam_wsol_video_tpu_torch.cli import demo_video

    frames = {}
    real_build = demo_video.wsol_viz.build_demo_video
    real_planner = demo_video.FrameReusePlanner

    def build(fr, path, **kw):
        frames[path] = [np.array(f) for f in fr]
        return real_build(fr, path, **kw)

    demo_video.wsol_viz.build_demo_video = build
    demo_video.FrameReusePlanner = planner_cls
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = demo_video.main(argv)
        res["wall_s"] = time.perf_counter() - t0
    finally:
        demo_video.wsol_viz.build_demo_video = real_build
        demo_video.FrameReusePlanner = real_planner
    res["frames_by_path"] = frames
    res["planner"] = planner_cls.made[-1]
    return res


def check_avis(tag: str, res: dict) -> dict:
    """Each AVI holds its video's frames (chunks and index); its frame 0,
    decoded by nvJPEG, is within the JPEG bound of the overlay array."""
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    check(len(res["written"]) == PATH_O_VIDEOS,
          f"{tag}: {len(res['written'])} videos written, not "
          f"{PATH_O_VIDEOS}")
    psnrs = []
    for path in res["written"]:
        check(os.path.isfile(path), f"{tag}: {path} was not written")
        want = res["frames_by_path"][path]
        jpegs, n_index = read_avi_frames(path)
        check(len(jpegs) == n_index == len(want) > 0,
              f"{tag}: {path} holds {len(jpegs)} frames ({n_index} "
              f"indexed), not {len(want)}")
        tmp = path + ".frame0.jpg"
        with open(tmp, "wb") as f:
            f.write(jpegs[0])
        dec = nvjpeg_loader.decode(tmp).cpu().numpy()
        os.remove(tmp)
        check(dec.shape == want[0].shape, f"{tag}: frame 0 decodes to "
              f"{dec.shape}, not {want[0].shape}")
        psnrs.append(luma_psnr(dec, want[0]))
    check(min(psnrs) >= DEMO_LUMA_PSNR_DB, f"{tag}: frame 0 luma PSNR "
          f"{min(psnrs):.2f} dB under {DEMO_LUMA_PSNR_DB}")
    n = sum(len(v) for v in res["frames_by_path"].values())
    check(n == res["frames"], f"{tag}: {n} frames in the AVIs, "
          f"{res['frames']} frames seen")
    return {"videos": len(res["written"]), "frames": n,
            "frame0_luma_psnr_min_db": min(psnrs)}


def phase_demo(seed: int, data: dict, path_d: dict) -> dict:
    """Path O on path D's set and its UnetTCAM ResNet-50 snapshot (crop
    224, eval bs 32): cli/demo_video.main on the card over the
    test-video-demo split (10 videos), with reuse off and with the
    threshold at the median frame-to-frame mean |delta| of the first run;
    then path D's trainer for 1 epoch with the CAM-progress grid and the
    final visual dump (every file JAX's hooks write); then
    cli/evaluate.main --multi_contour_eval false on path D's snapshot,
    counts reset just before each."""
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import constants

    root = data["root"]
    store = os.path.join(root, "cams")
    base = common_flags(root, seed) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--eval_batch_size", "32",
        "--freeze_cl", "True", "--exp_dir", path_d["outd"],
        "--max_videos", str(PATH_O_VIDEOS)]
    out = {"runs": {}}
    planner_cls = _checked_planner()
    reset_counts()
    first = run_demo(base + ["--out", os.path.join(root, "demo_0")],
                     planner_cls)
    out["launches_demo"] = read_counts()
    threshold = float(np.median(first["planner"].diffs))
    second = run_demo(base + ["--out", os.path.join(root, "demo_reuse"),
                              "--reuse_threshold", f"{threshold:.6f}"],
                      planner_cls)
    for name, res, thr in (("no_reuse", first, 0.0),
                           ("reuse", second, threshold)):
        p = res["planner"]
        avi = check_avis(f"path O {name}", res)
        rec = {"threshold": thr, "computed": res["computed"],
               "reused": res["reused"],
               "reused_checked": p.reused_checked,
               "compute_s": res["compute_s"], "wall_s": res["wall_s"],
               "model_frames_per_s": res["frames"] / res["compute_s"],
               "frames_per_s": res["frames"] / res["wall_s"], **avi}
        out["runs"][name] = rec
        print(f"[path O demo {name}] threshold {thr:.3f}: {res['computed']}"
              f" rows computed, {res['reused']} reused ({p.reused_checked} "
              f"checked against their video's last computed CAM); "
              f"{avi['frames']} frames in {avi['videos']} AVIs, frame 0 "
              f"luma PSNR min {avi['frame0_luma_psnr_min_db']:.2f} dB; "
              f"{rec['model_frames_per_s']:.1f} frames/s in the eval step "
              f"and its readback, {rec['frames_per_s']:.1f} frames/s end to"
              f" end ({res['wall_s']:.2f} s)", flush=True)
    check(first["reused"] == 0, "path O: frames reused at threshold 0")
    check(second["reused"] > 0 and second["computed"] > 0,
          f"path O: at threshold {threshold:.3f} {second['reused']} rows "
          f"reused, {second['computed']} computed")
    check(second["planner"].reused_checked == second["reused"],
          "path O: not every reused row was checked")

    # path D's trainer for 1 epoch with the progress grid and the visuals
    reset_counts()
    t0 = time.perf_counter()
    res = cli_train.main(path_d_flags(
        root, store, os.path.join(root, "exps_o"), epochs=PATH_O_EPOCHS,
        exp_id="o") + ["--plot_tr_cam_progress", "true"])
    torch.cuda.synchronize()
    out["trainer_wall_s"] = time.perf_counter() - t0
    launches = read_counts()
    steps = sum(r["steps"] for r in res["records"]["train"])
    check(launches["bilateral_exact"]["kernel"] == steps,
          f"path O trainer: kernel 1 launched "
          f"{launches['bilateral_exact']['kernel']} times in {steps} steps")
    outd = res["outd"]
    want = list(VISUAL_FILES)
    for tag in res["test"]:
        want += [f"best_tau_test_{tag}.yaml", f"boxacc_test_{tag}.png"]
    for s in (30, 50, 70):
        want += [f"visuals/test/ordered_iou_{s}.yaml",
                 f"visuals/test/ordered_iou_{s}.txt"]
    missing = [f for f in want if not os.path.isfile(os.path.join(outd, f))]
    sheets = {s: len([f for f in os.listdir(os.path.join(
        outd, "visuals", "test", str(s))) if f.endswith(".png")])
        for s in (30, 50, 70)}
    some = len([f for f in os.listdir(os.path.join(
        outd, "visuals", "test", "some_taux")) if f.endswith(".png")])
    print(f"[path O trainer] {steps} steps, kernel 1 x"
          f"{launches['bilateral_exact']['kernel']}; {len(want)} of JAX's "
          f"files checked, missing {missing}; sheets per IoU {sheets}, "
          f"some_taux {some}; cli/train.main {out['trainer_wall_s']:.1f} s",
          flush=True)
    check(not missing, f"path O trainer: missing {missing}")
    # 16 images (visual_dump_n) a test pass; both snapshots' passes write
    # to visuals/test, where an image ranked alike by both is one file
    check(all(16 <= v <= 32 for v in sheets.values()) and some == 16,
          "path O trainer: not 16 prediction sheets a test pass")
    out.update(trainer_launches=launches, trainer_steps=steps,
               visual_files=len(want))

    # the single-largest-contour protocol on path D's snapshot
    reset_counts()
    ev = cli_evaluate.main(common_flags(root, seed) + [
        "--task", "TCAM", "--arch", "UnetTCAM", "--eval_batch_size", "32",
        "--freeze_cl", "True", "--exp_dir", path_d["outd"],
        "--multi_contour_eval", "false"])
    out["single_contour"] = {k: v for k, v in ev.items()
                             if isinstance(v, (int, float))}
    out["single_contour"]["timing"] = ev["timing"]
    print(f"[path O evaluate] --multi_contour_eval false on path D's "
          f"{constants.BEST_LOC}: MaxBoxAcc 30/50/70 " + "/".join(
              f"{ev[f'maxboxacc_{s}']:.2f}" for s in (30, 50, 70))
          + f", {ev['n_images']} images, host contour sweep "
          f"{ev['timing']['sweep_ms_per_image']:.3f} ms/image at "
          f"cam_curve_interval 0.01 ({ev['timing']['images_per_s']:.1f} "
          f"images/s)", flush=True)
    check(ev["n_images"] == 320, "path O evaluate: not 320 images")
    check(ev["timing"]["sweep"] == "host", "path O evaluate: not the host "
          "sweep")
    return out


# --------------------------------------------- path P: the image datasets
PATH_P_FRAMES_PER_SHOT = 2
PATH_P_CHUNKS = 16          # 2 buckets of ILSVRC's bucket_sz 8


def make_image_sets(data: dict) -> dict:
    """Path D's frames as CUB, ILSVRC and OpenImages: the first
    PATH_P_FRAMES_PER_SHOT frames of each train shot are train images;
    val and test keep path D's frames and boxes (OpenImages: each test
    and val frame's box as a PNG mask under a mask tree of its own);
    ILSVRC's train ids in PATH_P_CHUNKS chunk files."""
    from tcam_wsol_video_tpu_torch.data import folds, png

    synth = data["synth"]
    base = os.path.join(data["root"], "image_sets")
    shutil.rmtree(base, ignore_errors=True)
    mask_root = os.path.join(base, "masks")
    meta = {}
    for ds in ("CUB", "ILSVRC", "OpenImages"):
        os.makedirs(os.path.join(base, "data"), exist_ok=True)
        os.symlink(synth["data_root"], os.path.join(base, "data", ds))
        meta[ds] = os.path.join(base, "folds", ds)
    train_ids = []
    for split in ("train", "val", "test"):
        md = folds.load_split_metadata(synth["metadata_root"], split)
        if split == "train":
            ids = [f"{s}/{f}" for s in md.image_ids for f in sorted(
                os.listdir(os.path.join(synth["data_root"], s)))[
                    :PATH_P_FRAMES_PER_SHOT]]
            labels = {i: md.labels["/".join(i.split("/")[:5])] for i in ids}
            train_ids = ids
        else:
            ids, labels = md.image_ids, md.labels
        for ds, d in meta.items():
            sd = os.path.join(d, split)
            os.makedirs(sd, exist_ok=True)
            with open(os.path.join(sd, "image_ids.txt"), "w") as f:
                f.writelines(f"{i}\n" for i in ids)
            with open(os.path.join(sd, "class_labels.txt"), "w") as f:
                f.writelines(f"{i},{labels[i]}\n" for i in ids)
            with open(os.path.join(sd, "image_sizes.txt"), "w") as f:
                f.writelines(f"{i},{md.sizes[i][0]},{md.sizes[i][1]}\n"
                             for i in ids if i in md.sizes)
            with open(os.path.join(sd, "localization.txt"), "w") as f:
                for i in ids if split != "train" else ():
                    if ds == "OpenImages":
                        f.write(f"{i},{i}.mask.png\n")
                        continue
                    for b in md.boxes[i]:
                        f.write(f"{i},{b[0]},{b[1]},{b[2]},{b[3]}\n")
        if split != "train":
            for i in ids:
                w, h = md.sizes[i]
                m = np.zeros((h, w), np.uint8)
                for x0, y0, x1, y1 in md.boxes[i]:
                    m[int(y0):int(y1) + 1, int(x0):int(x1) + 1] = 255
                path = os.path.join(mask_root, f"{i}.mask.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                png.write_png(path, m)
    per = -(-len(train_ids) // PATH_P_CHUNKS)
    for c in range(PATH_P_CHUNKS):
        with open(os.path.join(meta["ILSVRC"], "train",
                               f"train_chunk_{c}.txt"), "w") as f:
            f.writelines(f"{i}\n" for i in train_ids[c * per:(c + 1) * per])
    return {"base": base, "data_root": os.path.join(base, "data"),
            "meta": meta, "mask_root": mask_root, "train_ids": train_ids}


def image_set_flags(sets: dict, ds: str, outd: str, seed: int) -> list:
    """STD_CL ResNet-50/WGAP at crop 224, bs 32, 1 epoch, on `ds`."""
    return [
        "--dataset", ds, "--data_root", sets["data_root"],
        "--metadata_root", sets["meta"][ds], "--crop_size", "224",
        "--resize_size", "256", "--cam_curve_interval", "0.01",
        "--seed", str(seed), "--log_every", "0", "--device", "cuda",
        "--task", "STD_CL", "--batch_size", "32", "--eval_batch_size", "32",
        "--max_epochs", "1", "--lr", "0.001", "--checkpoint_save", "0",
        "--outd", outd, "--exp_id", ds.lower()]


def phase_image_sets(seed: int, data: dict) -> dict:
    """Path P: CUB (cli/train.main 1 epoch, then cli/evaluate.main on its
    best-localization snapshot), OpenImages' PxAP route (cli/evaluate.main
    on the same snapshot over the masks), and ILSVRC's bucket loop
    (cli/train.main 1 epoch over 2 buckets with `true` as the stage and
    cleanup commands: every train id once), counts reset just before
    each."""
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline

    t0 = time.perf_counter()
    sets = make_image_sets(data)
    out = {"setup_s": time.perf_counter() - t0,
           "train_images": len(sets["train_ids"])}
    outd = os.path.join(data["root"], "exps_p")

    reset_counts()
    t0 = time.perf_counter()
    cub = cli_train.main(image_set_flags(sets, "CUB", outd, seed))
    out["cub_wall_s"] = time.perf_counter() - t0
    out["cub_launches"] = read_counts()
    tr = cub["records"]["train"][0]
    check(tr["n"] == len(sets["train_ids"]), f"path P CUB: {tr['n']} "
          f"train images, not {len(sets['train_ids'])}")
    check(cub["args"].num_classes == 200, "path P CUB: not 200 classes")
    snap = cub["outd"]
    ev = cli_evaluate.main(image_set_flags(sets, "CUB", outd, seed)[:-4]
                           + ["--exp_dir", snap])
    out["cub"] = {"train": tr, "test_best_loc": {
        k: v for k, v in cub["test"][constants.BEST_LOC].items()
        if isinstance(v, (int, float))}, "evaluate": {
        k: v for k, v in ev.items() if isinstance(v, (int, float))}}
    trainer50 = cub["test"][constants.BEST_LOC]["maxboxacc_50"]
    print(f"[path P CUB] {tr['steps']} steps, median step "
          f"{tr['median_step_ms']:.2f} ms, data wait "
          f"{tr['data_wait_ms_per_step']:.2f} ms/step; test MaxBoxAcc "
          f"30/50/70 " + "/".join(f"{ev[f'maxboxacc_{s}']:.2f}"
                                  for s in (30, 50, 70))
          + f" (evaluate), the trainer's {trainer50:.2f} at 50; "
          f"cli/train.main {out['cub_wall_s']:.1f} s", flush=True)
    check(ev["n_images"] == 320, "path P CUB evaluate: not 320 images")

    # OpenImages' PxAP route on the CUB snapshot (200 classes)
    reset_counts()
    oi = cli_evaluate.main(
        image_set_flags(sets, "OpenImages", outd, seed)[:-4]
        + ["--exp_dir", snap, "--num_classes", "200", "--mask_root",
           sets["mask_root"]])
    out["openimages"] = {k: v for k, v in oi.items()
                         if isinstance(v, (int, float))}
    out["openimages"]["timing"] = oi["timing"]
    print(f"[path P OpenImages] PxAP {oi['pxap']:.3f} over "
          f"{oi['n_images']} images (masks read and histogrammed "
          f"{oi['timing']['sweep_ms_per_image']:.3f} ms/image on the "
          f"host), classification {oi['classification']:.2f}", flush=True)
    check(oi["timing"]["sweep"] == "pxap" and oi["n_images"] == 320,
          "path P OpenImages: not the PxAP route over 320 images")
    check(0.0 < oi["pxap"] <= 100.0, f"path P OpenImages: PxAP "
          f"{oi['pxap']}")

    # ILSVRC: 2 buckets, every train id once
    seen = []
    real = DataPipeline.epoch

    def spy(self, epoch, subset=None):
        for b in real(self, epoch, subset):
            if self.ds.split == constants.TRAINSET:
                valid = b["valid"].cpu().numpy()
                seen.extend(i for i, v in zip(b["image_id"], valid) if v)
            yield b

    DataPipeline.epoch = spy
    reset_counts()
    t0 = time.perf_counter()
    try:
        il = cli_train.main(image_set_flags(sets, "ILSVRC", outd, seed) + [
            "--nbr_chunks", str(PATH_P_CHUNKS), "--bucket_stage_cmd", "true",
            "--bucket_cleanup_cmd", "true"])
    finally:
        DataPipeline.epoch = real
    out["ilsvrc_wall_s"] = time.perf_counter() - t0
    tr = il["records"]["train"][0]
    out["ilsvrc"] = {"train": tr, "buckets": il["args"].nbr_buckets,
                     "seen": len(seen), "distinct": len(set(seen))}
    print(f"[path P ILSVRC] {il['args'].nbr_buckets} buckets, {tr['steps']}"
          f" steps, median step {tr['median_step_ms']:.2f} ms, data wait "
          f"{tr['data_wait_ms_per_step']:.2f} ms/step; {len(seen)} train "
          f"rows, {len(set(seen))} distinct of {len(sets['train_ids'])}; "
          f"cli/train.main {out['ilsvrc_wall_s']:.1f} s", flush=True)
    check(il["args"].nbr_buckets == 2, "path P ILSVRC: not 2 buckets")
    check(sorted(seen) == sorted(sets["train_ids"]),
          "path P ILSVRC: the epoch did not see every train id once")
    shutil.rmtree(sets["base"])
    return out


# ---------------------------------------------- the torchvision import
# the card against the CPU at fp32 with TF32 off (the C_BOX hold's bound)
IMPORT_RTOL = CBOX_TERM_RTOL


def phase_import(seed: int) -> dict:
    """A torchvision-named ResNet-50 state dict (random, seeded), saved
    with torch.save, loaded into the port's STD_CL ResNet-50 on the card
    and on the CPU (models/import_torch.py); the eval forward's logits of
    4 images at 224 px, TF32 off, within IMPORT_RTOL."""
    import copy
    from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
    from tcam_wsol_video_tpu_torch.models import import_torch
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args

    torch.manual_seed(seed)
    cpu = create_model_from_args(TCAMConfig(), device="cpu").eval()
    probe = {f"layer{i}.0.downsample.0.weight": 0 for i in range(1, 5)}
    own = cpu.encoder.state_dict()
    rng = np.random.default_rng(seed)
    sd = {"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}
    for src, dst in import_torch.NAME_MAPS["resnet50"](probe):
        shape = tuple(own[dst].shape)
        if src.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif src.endswith(("running_mean", "bias")):
            v = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 1:
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        sd[src] = torch.from_numpy(v.astype(np.float32))
    path = os.path.join(ROOT, "build", "chip_smoke_resnet50_tv.pth")
    torch.save(sd, path)
    card = copy.deepcopy(cpu).to("cuda")
    t0 = time.perf_counter()
    import_torch.load_pretrained_encoder(card, path, "resnet50")
    load_ms = (time.perf_counter() - t0) * 1e3
    import_torch.load_pretrained_encoder(cpu, path, "resnet50")
    os.remove(path)
    check(torch.equal(card.encoder.conv1.weight.cpu(), sd["conv1.weight"]),
          "import: conv1 is not the file's")
    x = torch.from_numpy(rng.normal(0, 1, (4, 224, 224, 3)).astype(
        np.float32))
    with exact_fp32(), torch.no_grad():
        got = card(x.cuda(), torch.float32)["cl_logits"].double().cpu()
        want = cpu(x, torch.float32)["cl_logits"].double()
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[import] torchvision ResNet-50 ({len(sd)} tensors, fc "
          f"dropped) into the port's encoder on the card in {load_ms:.1f} "
          f"ms; logits card vs CPU rel {rel:.3e} (tol {IMPORT_RTOL})",
          flush=True)
    check(rel <= IMPORT_RTOL, f"import: logits card vs CPU rel {rel:.3e}")
    return {"tensors": len(sd), "load_ms": load_ms, "logits_rel": rel}


# ---------------------------------------------- the landmark filter's solve
# the lockstep solve against cholesky_ex, relative L2
# (tests/test_torch_landmarks.py's SOLVE_RTOL)
SOLVE_RTOL = 5e-4


def phase_solve(seed: int, b: int = 32, crop: int = 224,
                m_req: int = 1024) -> dict:
    """At path B's shapes (G = 32 systems K_mm + 1e-2 I of M = 1024
    landmarks, K = 2): the lockstep solve against cholesky_ex, each timed;
    then the fused route (whose solve is the lockstep one) against its
    plain version."""
    from tcam_wsol_video_tpu_torch.ops import linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    feats, fm, idx, vals = landmark_inputs(gen, b, crop, crop, 100.0, m_req)
    kmm = landmarks.add_ridge(landmarks.build_knm(fm, fm), 1e-2)
    rhs = landmarks.nystrom_rhs(feats, fm, vals)
    with linalg.record_info() as infos:
        cho = linalg.batched_cholesky_solve(kmm, rhs)
    check_infos(infos, "solve phase")
    lock = linalg.lockstep_solve(kmm, rhs)
    rel = float((lock - cho).norm() / cho.norm())
    t = {"cholesky_ex_ms": cuda_time_ms(
        lambda: linalg.batched_cholesky_solve(kmm, rhs), 5),
        "lockstep_ms": cuda_time_ms(lambda: linalg.lockstep_solve(kmm, rhs),
                                    3),
        "lockstep_vs_cholesky_rel": rel, "shape": [b, fm.shape[1], 2]}
    t["lockstep_spread"] = spread(cuda_call_ms(
        lambda: linalg.lockstep_solve(kmm, rhs), 5))
    print(f"[solve] G={b} M={fm.shape[1]} K={vals.shape[2]}: lockstep "
          f"{t['lockstep_ms']:.3f} ms (per call median "
          f"{t['lockstep_spread']['median']:.3f}), cholesky_ex "
          f"{t['cholesky_ex_ms']:.3f} ms; lockstep vs cholesky_ex rel "
          f"{rel:.3e} (tol {SOLVE_RTOL})", flush=True)
    check(rel <= SOLVE_RTOL, f"lockstep solve {rel:.3e} off cholesky_ex")
    row = _rel_row("nystrom_filter_fused", f"B{b}_{crop}x{crop}_lockstep",
                   landmarks.nystrom_filter(feats, vals, idx),
                   landmarks.nystrom_filter_plain(feats, vals, idx),
                   [b, feats.shape[1], feats.shape[2], fm.shape[1], 2],
                   LMK_RTOL)
    t["fused_check"] = row
    del feats, fm, vals, kmm, rhs, cho, lock
    torch.cuda.empty_cache()
    return t


# ------------------------------------------------------------ TF32 vs fp32
def phase_tf32_gap(seed: int, tf32_steps: list) -> dict:
    """Path A at float32 runs its cuDNN convolutions in TF32.  Rebuild the
    same starting state, run two steps with every convolution in full
    fp32, and hold the first step's loss terms against that path's first
    step (same weights, batch and seeder noise)."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        (_, _, _, state, train_step, _, batch, gen,
         switches) = build_main_path(seed, dtype="float32")
        recs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = train_step(state, batch, switches, seed_weighted=True,
                             generator=gen)
            torch.cuda.synchronize()
            rec = {k: float(v) for k, v in met.items()}
            rec["step_ms"] = (time.perf_counter() - t0) * 1e3
            recs.append(rec)
        del state, batch
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    gap = {}
    for k, v in recs[0].items():
        if k in ("step_ms", "n", "n_correct"):
            continue
        ref = tf32_steps[0][k]
        gap[k] = abs(ref - v) / max(abs(v), 1e-30) if ref != v else 0.0
        print(f"[tf32] step 0 {k}: fp32={v:.8e} tf32={ref:.8e} "
              f"rel={gap[k]:.3e} (tol {TF32_RTOL})", flush=True)
    print(f"[tf32] fp32-convolution step (2nd step) {recs[1]['step_ms']:.2f}"
          f" ms", flush=True)
    for k, rel in gap.items():
        check(rel <= TF32_RTOL, f"TF32 step-0 {k} is {rel:.3e} off fp32")
    return {"fp32_steps": recs, "rel_gap": gap, "rtol": TF32_RTOL}


def phase_bf16_gap(bf16_steps: list, fp32_steps: list) -> dict:
    """Path A's first bf16 step against the first full-fp32 step of the
    TF32 gap: the same weights, batch and seeder noise, only the compute
    dtype differs.  Each loss term within BF16_RTOL of fp32, and the total
    within BF16_RTOL of the sum of the terms' magnitudes (the terms cancel
    in the total: 0.72 - 0.48 - 0.10)."""
    ref = fp32_steps[0]
    terms = [k for k in ref if k not in ("step_ms", "n", "n_correct",
                                         "loss")]
    gap = {}
    for k in ["loss"] + terms:
        v, got = ref[k], bf16_steps[0][k]
        scale = (sum(abs(ref[t]) for t in terms) if k == "loss"
                 else abs(v))
        gap[k] = abs(got - v) / max(scale, 1e-30) if got != v else 0.0
        print(f"[bf16] step 0 {k}: fp32={v:.8e} bf16={got:.8e} "
              f"rel={gap[k]:.3e} (tol {BF16_RTOL}"
              + (", of the terms' magnitudes)" if k == "loss" else ")"),
              flush=True)
    for k, rel in gap.items():
        check(rel <= BF16_RTOL, f"bf16 step-0 {k} is {rel:.3e} off fp32")
    return {"rel_gap": gap, "rtol": BF16_RTOL}


@contextlib.contextmanager
def conv_weight_dtypes():
    """Counts, by dtype, the weights that the port's convolutions hand to
    cuDNN inside the block (the models' compute dtype at work)."""
    from tcam_wsol_video_tpu_torch.models import resnet
    seen = {}
    orig = resnet.Conv2d._conv_forward

    def counted(self, x, weight, bias):
        name = str(weight.dtype).replace("torch.", "")
        seen[name] = seen.get(name, 0) + 1
        return orig(self, x, weight, bias)

    resnet.Conv2d._conv_forward = counted
    try:
        yield seen
    finally:
        resnet.Conv2d._conv_forward = orig


def check_conv_dtypes(tag: str, seen: dict, want: set) -> dict:
    """`seen` (conv_weight_dtypes) holds exactly the dtypes `want`."""
    print(f"[{tag}] convolution weights by dtype: {seen}", flush=True)
    check(set(seen) == want, f"{tag}: convolutions ran in {sorted(seen)}, "
          f"expected {sorted(want)}")
    return dict(seen)


# --------------------------------------------------------- CRF loss parity
def phase_crf_parity(seed: int) -> dict:
    from tcam_wsol_video_tpu_torch.ops import crf
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, h, w = 2, 224, 224
    img = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
    segs = torch.softmax(torch.randn((b, h, w, 2), generator=gen,
                                     device="cuda"), -1)
    s = segs.clone().requires_grad_(True)
    loss = crf.dense_crf_loss(img, s, 15.0, 100.0)
    loss.backward()
    feats = crf.make_bilateral_features(img, 15.0, 100.0)
    as_ = bilateral.gaussian_filter_apply_plain(
        feats, segs.reshape(b, h * w, 2)).reshape(b, h, w, 2)
    want_loss = -(segs * as_).sum() / b
    want_grad = -2.0 * as_ / b
    loss_rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    grad_rel = ((s.grad - want_grad).abs().max()
                / want_grad.abs().max()).item()
    print(f"[crf] loss kernel={loss.item():.8e} plain={want_loss.item():.8e}"
          f" rel={loss_rel:.3e}; grad rel={grad_rel:.3e} (tol {CRF_RTOL})",
          flush=True)
    check(loss_rel <= CRF_RTOL, f"CRF loss disagrees ({loss_rel:.3e})")
    check(grad_rel <= CRF_RTOL, f"CRF grad disagrees ({grad_rel:.3e})")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "rtol": CRF_RTOL}


def phase_landmark_parity(seed: int) -> dict:
    """The landmark CRF loss and its segs-gradient at batch 2, 224 px,
    M = 1024, through the kernels (build route and fused route) against
    the same from the plain version."""
    from tcam_wsol_video_tpu_torch.ops import crf
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    b, h, w = 2, 224, 224
    img = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
    segs = torch.softmax(torch.randn((b, h, w, 2), generator=gen,
                                     device="cuda"), -1)
    feats = crf.make_bilateral_features(img, 15.0, 100.0)
    feats = (feats - feats.mean(1, keepdim=True)).contiguous()
    idx = torch.from_numpy(crf._landmark_grid_indices(h, w, 1024)).cuda()
    as_ = landmarks.nystrom_filter_plain(
        feats, segs.reshape(b, h * w, 2), idx).reshape(b, h, w, 2)
    want_loss = (-(segs * as_).sum() / b).item()
    want_grad = -2.0 * as_ / b
    out = {"rtol": LMK_RTOL}
    for route in ("build", "fused"):
        s = segs.clone().requires_grad_(True)
        with fused_landmarks(route == "fused"):
            loss = crf.dense_crf_loss(img, s, 15.0, 100.0,
                                      method="landmarks", n_landmarks=1024)
            loss.backward()
        loss_rel = abs(loss.item() - want_loss) / abs(want_loss)
        grad_rel = ((s.grad - want_grad).abs().max()
                    / want_grad.abs().max()).item()
        print(f"[crf landmarks {route}] loss kernel={loss.item():.8e} "
              f"plain={want_loss:.8e} rel={loss_rel:.3e}; grad rel="
              f"{grad_rel:.3e} (tol {LMK_RTOL})", flush=True)
        check(loss_rel <= LMK_RTOL,
              f"landmark CRF loss ({route}) disagrees ({loss_rel:.3e})")
        check(grad_rel <= LMK_RTOL,
              f"landmark CRF grad ({route}) disagrees ({grad_rel:.3e})")
        out[route] = {"loss_rel": loss_rel, "grad_rel": grad_rel}
    return out


# ------------------------------------------------------------------ timing
def filter_bound(b: int, p: int, d: int, k: int) -> dict:
    """The least work of the function, not of this kernel: the weight is
    symmetric, so each unordered pair (i, j) needs one exponential, D FMAs
    and an add and a min for its distance, and 2K FMAs for W v in both
    directions (the TPU kernel computes each pair once this way)."""
    pairs = b * p * (p + 1) // 2
    mufu_ms = pairs / MUFU_RATE * 1e3
    flop_ms = pairs * (2 * d + 2 + 4 * k) / FP32_FLOPS * 1e3
    byte_ms = 4 * b * p * (d + 2 * k) / HBM_BYTES * 1e3
    ops_ms = max(mufu_ms, flop_ms)
    return {"pairs": pairs, "mufu_ms": mufu_ms, "fp32_ms": flop_ms,
            "bytes_ms": byte_ms, "bound_ms": max(ops_ms, byte_ms),
            "bound_by": "operations" if ops_ms >= byte_ms else "bytes"}


def phase_timing(seed: int, b: int, crop: int) -> dict:
    """Times kernel and plain version on the same inputs and holds them
    together there (at B = 32 this is the main path's shape); the kernel's
    per-call spread and its scratch; raises if the kernel reads under its
    bound."""
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    feats, vals = filter_inputs(gen, b, crop, crop, 100.0)
    p = crop * crop

    def run():
        return bilateral.gaussian_filter_apply_batched(feats, vals)
    kernel_ms = cuda_time_ms(run, 3)
    per_call = spread(cuda_call_ms(run, 10 if b > 1 else 40))
    plain_ms = cuda_time_ms(
        lambda: bilateral.gaussian_filter_apply_plain(feats, vals), 1)
    check_row = compare_filter(f"B{b}_{crop}x{crop}_D5_K2_timed", feats,
                               vals, single=b == 1)
    bound = filter_bound(b, p, feats.shape[2], vals.shape[2])
    chunks = bilateral.plan(b, p, vals.shape[2],
                            bilateral.sm_count(torch.cuda.current_device()),
                            cap=bilateral.SCRATCH_CAP)
    scratch = {"bytes": max(sch.scratch_bytes for _, sch in chunks),
               "chunks": len(chunks), "nsplit": chunks[0][1].nsplit,
               "n_tiles": chunks[0][1].n_tiles}
    print(f"[time] bilateral B={b} P={p}: kernel {kernel_ms:.3f} ms (per "
          f"call median {per_call['median']:.3f}, min {per_call['min']:.3f}, "
          f"max {per_call['max']:.3f}, {per_call['n']} calls), plain "
          f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms (mufu "
          f"{bound['mufu_ms']:.3f}, fp32 {bound['fp32_ms']:.3f}, bytes "
          f"{bound['bytes_ms']:.4f}); scratch {scratch['bytes'] / 1e9:.3f} "
          f"GB in {scratch['chunks']} chunk(s), {scratch['n_tiles']} tiles, "
          f"nsplit {scratch['nsplit']}", flush=True)
    check(kernel_ms >= bound["bound_ms"] and per_call["min"] >=
          bound["bound_ms"], f"bilateral B={b}: {kernel_ms:.3f} ms reads "
          f"under its bound {bound['bound_ms']:.3f} ms")
    return {"kernel_ms": kernel_ms, "per_call_ms": per_call,
            "plain_ms": plain_ms, "check": check_row, "scratch": scratch,
            **bound}


def landmark_bound(b: int, p: int, m: int, d: int, k: int = 0,
                   out_bytes: int = 0) -> dict:
    """The least work of the landmark functions over E = B P M entries,
    each entry one ex2 and, for its distance, D FMAs and an add and a min
    (2D + 2 flops; a Nystrom pass adds K FMAs, 2K flops).  build_knm
    (out_bytes > 0) reads feats and fm and writes E entries; a Nystrom
    pass reads feats, fm and its (B, P, K) or (B, M, K) values and writes
    a (B, M, K) or (B, P, K) result."""
    e = b * p * m
    mufu_ms = e / MUFU_RATE * 1e3
    flop_ms = e * (2 * d + 2 + 2 * k) / FP32_FLOPS * 1e3
    moved = 4 * b * (p + m) * d
    moved += e * out_bytes if out_bytes else 4 * b * (p + m) * k
    byte_ms = moved / HBM_BYTES * 1e3
    ops_ms = max(mufu_ms, flop_ms)
    return {"entries": e, "mufu_ms": mufu_ms, "fp32_ms": flop_ms,
            "bytes_ms": byte_ms, "bound_ms": max(ops_ms, byte_ms),
            "bound_by": "operations" if ops_ms >= byte_ms else "bytes"}


def phase_landmark_timing(seed: int, b: int = 32, crop: int = 224,
                          m_req: int = 1024) -> dict:
    """Times build_knm, the two Nystrom passes, their plain versions, the
    build route's two consumer products and both filter routes at path B's
    shapes, and holds kernels and plain versions together there."""
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    feats, fm, idx, vals = landmark_inputs(gen, b, crop, crop, 100.0, m_req)
    p, d = feats.shape[1], feats.shape[2]
    m, k = fm.shape[1], vals.shape[2]
    t = {}
    t["knm_ms"] = cuda_time_ms(lambda: landmarks.build_knm(feats, fm), 5)
    t["knm_bf16_ms"] = cuda_time_ms(
        lambda: landmarks.build_knm(feats, fm, out_dtype=torch.bfloat16), 5)
    t["knm_plain_ms"] = cuda_time_ms(
        lambda: landmarks.build_knm_plain(feats, fm), 2)
    knm = landmarks.build_knm(feats, fm)
    want = landmarks.build_knm_plain(feats, fm)
    rows = [compare_knm(f"B{b}_{crop}x{crop}_D{d}_M{m}_timed", feats, fm,
                        want=want)]
    del want
    t["consumer_rhs_bmm_ms"] = cuda_time_ms(
        lambda: torch.bmm(knm.transpose(1, 2), vals), 5)
    rhs = torch.bmm(knm.transpose(1, 2), vals)
    kmm = landmarks.add_ridge(landmarks.build_knm(fm, fm), 1e-2)
    t["solve_ms"] = cuda_time_ms(
        lambda: linalg.batched_cholesky_solve(kmm, rhs), 5)
    alpha = linalg.batched_cholesky_solve(kmm, rhs)
    t["consumer_out_bmm_ms"] = cuda_time_ms(lambda: torch.bmm(knm, alpha),
                                            5)
    del knm
    torch.cuda.empty_cache()
    t["rhs_ms"] = cuda_time_ms(lambda: landmarks.nystrom_rhs(feats, fm, vals),
                               5)
    t["rhs_plain_ms"] = cuda_time_ms(
        lambda: landmarks.nystrom_rhs_plain(feats, fm, vals), 2)
    rows.append(_rel_row("nystrom_rhs", f"B{b}_{crop}x{crop}_timed",
                         landmarks.nystrom_rhs(feats, fm, vals),
                         landmarks.nystrom_rhs_plain(feats, fm, vals),
                         [b, p, d, m, k], FILTER_RTOL))
    t["out_ms"] = cuda_time_ms(
        lambda: landmarks.nystrom_out(feats, fm, alpha), 5)
    t["out_plain_ms"] = cuda_time_ms(
        lambda: landmarks.nystrom_out_plain(feats, fm, alpha), 2)
    rows.append(_rel_row("nystrom_out", f"B{b}_{crop}x{crop}_timed",
                         landmarks.nystrom_out(feats, fm, alpha),
                         landmarks.nystrom_out_plain(feats, fm, alpha),
                         [b, p, d, m, k], LMK_RTOL))
    t["filter_build_route_ms"] = cuda_time_ms(
        lambda: crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                    fused=False), 3)
    t["filter_fused_route_ms"] = cuda_time_ms(
        lambda: crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                    fused=True), 3)
    t["filter_plain_ms"] = cuda_time_ms(
        lambda: landmarks.nystrom_filter_plain(feats, vals, idx), 2)
    # call-to-call spread of the routes and of the library solve under
    # each of torch's linalg back ends (the port sets none)
    t["spread"] = {
        "filter_fused_route": spread(cuda_call_ms(
            lambda: crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                        fused=True), 20)),
        "filter_build_route": spread(cuda_call_ms(
            lambda: crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                        fused=False), 10))}
    lib0 = torch.backends.cuda.preferred_linalg_library()
    try:
        for lib in ("default", "cusolver", "magma"):
            torch.backends.cuda.preferred_linalg_library(lib)
            t["spread"][f"solve_{lib}"] = spread(cuda_call_ms(
                lambda: linalg.batched_cholesky_solve(kmm, rhs), 20))
    finally:
        torch.backends.cuda.preferred_linalg_library(lib0)
    for key, sp in t["spread"].items():
        print(f"[time] {key} per call: median {sp['median']:.3f} ms, min "
              f"{sp['min']:.3f}, max {sp['max']:.3f} ({sp['n']} calls)",
              flush=True)
    t["bounds"] = {
        "knm_build": landmark_bound(b, p, m, d, out_bytes=4),
        "knm_build_bf16": landmark_bound(b, p, m, d, out_bytes=2),
        "nystrom_rhs": landmark_bound(b, p, m, d, k),
        "nystrom_out": landmark_bound(b, p, m, d, k),
        # the build route's consumers read the fp32 K_nm twice
        "consumer_bmms_bytes_ms": 2 * 4 * b * p * m / HBM_BYTES * 1e3}
    t["checks"] = rows
    for key in ("knm", "knm_bf16", "rhs", "out"):
        bkey = {"knm": "knm_build", "knm_bf16": "knm_build_bf16",
                "rhs": "nystrom_rhs", "out": "nystrom_out"}[key]
        bd = t["bounds"][bkey]
        plain = t.get(f"{key}_plain_ms")
        print(f"[time] {bkey} B={b} P={p} M={m}: kernel {t[key + '_ms']:.3f}"
              f" ms, plain " + (f"{plain:.3f} ms" if plain else "-")
              + f", bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}: mufu "
              f"{bd['mufu_ms']:.3f}, fp32 {bd['fp32_ms']:.3f}, bytes "
              f"{bd['bytes_ms']:.3f})", flush=True)
        check(t[key + "_ms"] >= bd["bound_ms"], f"{bkey}: "
              f"{t[key + '_ms']:.3f} ms reads under its bound "
              f"{bd['bound_ms']:.3f} ms")
    print(f"[time] build route: rhs bmm {t['consumer_rhs_bmm_ms']:.3f} ms, "
          f"solve {t['solve_ms']:.3f} ms, out bmm "
          f"{t['consumer_out_bmm_ms']:.3f} ms (the bmms' K_nm reads: "
          f"{t['bounds']['consumer_bmms_bytes_ms']:.3f} ms); whole filter: "
          f"build route {t['filter_build_route_ms']:.3f} ms, fused route "
          f"{t['filter_fused_route_ms']:.3f} ms, plain "
          f"{t['filter_plain_ms']:.3f} ms", flush=True)
    del feats, fm, vals, rhs, kmm, alpha
    torch.cuda.empty_cache()
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (torch.profiler)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="path D, then path N alone (several ranks); not "
                    "the whole check")
    ap.add_argument("--visuals-only", action="store_true",
                    help="path D, then paths O and P and the import phase "
                    "alone; not the whole check")
    a = ap.parse_args(argv)

    # the port first: without the checkout around the script this fails
    # (ModuleNotFoundError, exit 1) on any machine, before any work
    from tcam_wsol_video_tpu_torch.core import nativebuild
    from tcam_wsol_video_tpu_torch.ops.cuda import build
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2

    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    print(f"[precision] cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(1) as pool:
        host = pool.submit(nativebuild.build_all, ["boxsweep", "contours"],
                           True)
        built = build.build_all(force=True)
        host_built = host.result()
    for name, res in host_built.items():
        print(f"[build] {name} (g++) in {res['seconds']:.1f} s", flush=True)
    for name, res in built.items():
        print(f"[build] {name}.cu in {res['seconds']:.1f} s", flush=True)
        for line in res["log"].splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    result = {"device": smi,
              "build_s": {n: r["seconds"] for n, r in {**built,
                                                        **host_built}.items()},
              "ptxas": {n: r["log"] for n, r in built.items()}}
    if a.mesh_only or a.visuals_only:
        data = make_trainer_set(SEED)
        result["trainer"] = phase_trainer(SEED, data)
        if a.mesh_only:
            result["mesh"] = phase_mesh(SEED, data, result["trainer"])
        else:
            t_new = time.perf_counter()
            result["demo"] = phase_demo(SEED, data, result["trainer"])
            result["image_sets"] = phase_image_sets(SEED, data)
            result["import"] = phase_import(SEED)
            result["paths_o_p_s"] = time.perf_counter() - t_new
            print(f"[summary] paths O, P and the import phase "
                  f"{result['paths_o_p_s']:.1f} s", flush=True)
        shutil.rmtree(data["root"])
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        name = "mesh" if a.mesh_only else "visuals"
        with open(os.path.join(ROOT, "chiprun_out",
                               f"chip_smoke_{name}.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
        print(smi)
        return 0
    result["checks"] = phase_kernel_checks(SEED)
    result["bit_equal"] = check_bit_equal(SEED)
    result["checks"] += phase_landmark_checks(SEED)
    result["nystrom_bit_equal"] = check_nystrom_bit_equal(SEED)
    result["main_path"] = phase_main_path(SEED, STEPS, a.profile, "bfloat16")
    result["main_path_fp32"] = phase_main_path(SEED, STEPS, a.profile,
                                               "float32")
    result["tf32_gap"] = phase_tf32_gap(SEED,
                                        result["main_path_fp32"]["steps"])
    result["bf16_gap"] = phase_bf16_gap(result["main_path"]["steps"],
                                        result["tf32_gap"]["fp32_steps"])
    result["crf_parity"] = phase_crf_parity(SEED)
    result["loss_chunk_remat"] = phase_loss_chunk_remat(SEED)
    result["production"] = phase_production(SEED, STEPS, a.profile)
    result["crf_landmark_parity"] = phase_landmark_parity(SEED)
    data = make_trainer_set(SEED)
    result["trainer"] = phase_trainer(SEED, data)
    result["feed"] = phase_feed(SEED, data)
    result["chunked"] = phase_chunked(SEED, data)
    result["eval_knobs"] = phase_eval_knobs(SEED, data,
                                            result["chunked"]["snapshot"])
    result["chain"] = phase_chain(SEED, data)
    result["recompute"] = phase_recompute(SEED, data,
                                          result["chain"]["stage1_outd"])
    result["recipe_yaml"] = phase_recipe_yaml(SEED, data)
    result["f_cl"] = phase_f_cl(SEED, data)
    result["cbox"] = phase_cbox(SEED, data, result["chain"]["stage1_outd"])
    result["stage1_encoders"] = phase_stage1_encoders(SEED, data)
    result["tcam_vgg16"] = phase_tcam_vgg16(SEED, data,
                                            result["stage1_encoders"])
    result["cam_methods"] = phase_cam_methods(
        SEED, data, result["chain"]["stage1_outd"])
    result["mesh"] = phase_mesh(SEED, data, result["trainer"])
    t_new = time.perf_counter()
    result["demo"] = phase_demo(SEED, data, result["trainer"])
    result["image_sets"] = phase_image_sets(SEED, data)
    result["import"] = phase_import(SEED)
    result["paths_o_p_s"] = time.perf_counter() - t_new
    shutil.rmtree(data["root"])
    result["unet_encoders"] = phase_unet_encoders(SEED)
    result["roi"] = phase_roi(SEED)
    result["solve"] = phase_solve(SEED)
    result["checks"].append(result["solve"]["fused_check"])
    timing = phase_timing(SEED, 32, 224)
    result["timing"] = timing
    # the single-image function (the B = 1 case), off the main path
    result["timing_single_image"] = phase_timing(SEED, 1, 224)
    lmk = phase_landmark_timing(SEED)
    result["timing_landmarks"] = lmk
    result["checks"] += [timing["check"],
                         result["timing_single_image"]["check"]]
    result["checks"] += lmk["checks"]
    result["seconds"] = time.perf_counter() - t0

    def max_err(kernel):
        return max(r["max_abs_err"] for r in result["checks"]
                   if r.get("kernel", "bilateral_exact") == kernel)

    prod = result["production"]
    src = "tcam_wsol_video_tpu_torch/csrc/"
    kernels = [{
        "name": "bilateral_exact",
        "route": "cuda",
        "source": src + "bilateral.cu",
        "replaces": "tcam_wsol_video_tpu/ops/pallas/bilateral.py:183",
        # path E, this slice's main path (its stage-2 steps); paths D and
        # A beside it
        "launches": result["chain"]["launches"]["bilateral_exact"][
            "kernel"],
        "launches_path_d": result["trainer"]["launches"]["bilateral_exact"][
            "kernel"],
        "launches_path_a": result["main_path"]["launches"]["kernel"],
        "launches_path_f": result["recompute"]["launches"][
            "bilateral_exact"]["kernel"],
        "launches_path_g": result["feed"]["launches"]["bilateral_exact"][
            "kernel"],
        # path L: CUDA graph replays times the launches of one capture
        "launches_path_l": result["chunked"]["routes"]["chunked"][
            "launches"]["bilateral_exact"]["kernel"],
        "launches_path_h": result["recipe_yaml"]["launches"][
            "bilateral_exact"]["kernel"],
        "launches_path_i": result["f_cl"]["launches"]["bilateral_exact"][
            "kernel"],
        "launches_path_k": result["tcam_vgg16"]["launches"][
            "bilateral_exact"]["kernel"],
        # path M (C_BOX): no CRF, so 0
        "launches_path_m": result["cbox"]["launches"]["bilateral_exact"][
            "kernel"],
        # path N(b): both ranks' launches (once a step on each)
        "launches_path_n": result["mesh"]["launches"],
        "max_abs_err": max_err("bilateral_exact"),
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    # no single PyTorch call computes these functions (an unnormalized
    # Gaussian kernel block, or its product with values): library_ms null
    for name, key, launches in (
            ("knm_build", "knm", prod["launches"]["knm_build"]["kernel"]),
            ("nystrom_rhs", "rhs",
             prod["fused"]["launches"]["nystrom_rhs"]["kernel"]),
            ("nystrom_out", "out",
             prod["fused"]["launches"]["nystrom_out"]["kernel"])):
        bd = lmk["bounds"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "landmarks.cu",
            "replaces": "tcam_wsol_video_tpu/ops/pallas/landmarks.py:" + {
                "knm_build": "248", "nystrom_rhs": "137",
                "nystrom_out": "170"}[name],
            "launches": launches,
            "launches_path_g": result["feed"]["launches"][name]["kernel"],
            "launches_path_h": result["recipe_yaml"]["launches"][name][
                "kernel"],
            "launches_path_i": result["f_cl"]["launches"][name]["kernel"],
            "max_abs_err": max_err(name),
            "ms": lmk[f"{key}_ms"], "plain_ms": lmk[f"{key}_plain_ms"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "library_ms": None})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({**result, "kernels": kernels}, f, indent=1)
    for mp in (result["main_path"], result["main_path_fp32"]):
        print(f"[summary] path A {mp['dtype']}: median step "
              f"{mp['median_step_ms']:.2f} ms, CRF kernel in step "
              f"{mp['median_crf_kernel_ms']:.2f} ms, eval "
              f"{mp['eval_ms']:.2f} ms, peak {mp['peak_mem_gib']:.2f} GiB",
              flush=True)
    print(f"[summary] bf16 gap (path A step 0, bf16 vs fp32): " + ", ".join(
        f"{k} {v:.3e}" for k, v in result["bf16_gap"]["rel_gap"].items())
        + f" (tol {BF16_RTOL})", flush=True)
    print(f"[summary] path B float32: median step {prod['median_step_ms']:.2f} ms, "
          f"landmark CRF in step {prod['median_crf_ms']:.2f} ms, peak "
          f"{prod['peak_mem_gib']:.2f} GiB; fused route median step "
          f"{prod['fused_step_ms']:.2f} ms, CRF {prod['fused_crf_ms']:.2f} "
          f"ms; path C eval {prod['path_c']['eval_ms']:.2f} ms", flush=True)
    tr = result["trainer"]
    print(f"[summary] path D: {tr['steps']} steps in {PATH_D_EPOCHS} epochs,"
          f" median step " + "/".join(f"{r['median_step_ms']:.2f}"
                                       for r in tr["train"])
          + " ms, data wait " + "/".join(
              f"{r['data_wait_ms_per_step']:.2f}" for r in tr["train"])
          + f" ms/step, test MaxBoxAcc at best localization "
          f"{tr['test_best_loc']['maxboxacc_50']:.2f} (IoU 50, stand-in "
          f"CAMs); cli/train.main {tr['wall_s']:.1f} s", flush=True)
    ch = result["chain"]

    def per_epoch(train, key):
        return "/".join(f"{r[key]:.2f}" for r in train)
    print(f"[summary] path E: stage 1 median step "
          f"{per_epoch(ch['stage1']['train'], 'median_step_ms')} ms, data "
          f"wait {per_epoch(ch['stage1']['train'], 'data_wait_ms_per_step')}"
          f" ms/step, test MaxBoxAcc@50 "
          f"{ch['stage1']['test_best_loc']['maxboxacc_50']:.2f}; dump "
          f"{ch['dump']['frames_per_s']:.1f} frames/s; stage 2 median step "
          f"{per_epoch(ch['stage2']['train'], 'median_step_ms')} ms, data "
          f"wait {per_epoch(ch['stage2']['train'], 'data_wait_ms_per_step')}"
          f" ms/step, test MaxBoxAcc@50 "
          f"{ch['stage2']['test_best_loc']['maxboxacc_50']:.2f} (evaluate "
          f"{ch['evaluate']['maxboxacc_50']:.2f}); the chain "
          f"{ch['wall_s']:.1f} s", flush=True)
    pg = result["feed"]
    print(f"[summary] path G (uint8, decode cache, card-resident feed): "
          f"{pg['steps']} steps in {PATH_G_EPOCHS} epochs, median step "
          f"{per_epoch(pg['train'], 'median_step_ms')} ms, data wait "
          f"{per_epoch(pg['train'], 'data_wait_ms_per_step')} ms/step, "
          f"assembly {per_epoch(pg['train'], 'data_assembly_ms_per_step')} "
          f"ms/step, pool decodes "
          + "/".join(str(r["pool_decodes"]) for r in pg["train"])
          + f" ({pg['decodes']} for {pg['sampled_frames']} sampled frames),"
          f" test MaxBoxAcc@50 {pg['test_best_loc']['maxboxacc_50']:.2f}; "
          f"cli/train.main {pg['wall_s']:.1f} s", flush=True)
    pl = result["chunked"]["routes"]
    for name, r in pl.items():
        print(f"[summary] path L {name} (K "
              f"{r['train'][0]['dispatch_chunk']}): median step "
              f"{per_epoch(r['train'], 'median_step_ms')} ms, host enqueue "
              f"{per_epoch(r['train'], 'host_enqueue_ms_per_step')} ms/step,"
              f" data wait {per_epoch(r['train'], 'data_wait_ms_per_step')}"
              f" ms/step, epoch wall {per_epoch(r['train'], 'wall_ms')} ms, "
              f"bilateral_exact {r['launches']['bilateral_exact']['kernel']}"
              f" launches in {r['steps']} steps; cli/train.main "
              f"{r['wall_s']:.1f} s", flush=True)
    print("[summary] eval knobs (path D's test split, path L's snapshot): "
          + ", ".join(f"{n} {v['timing']['images_per_s']:.1f} images/s"
                      for n, v in result["eval_knobs"]["variants"].items()),
          flush=True)
    lr = result["loss_chunk_remat"]["runs"]
    print("[summary] path A step bf16: " + ", ".join(
        f"{n} peak {v['peak_mem_gib']:.2f} GiB, kernel 1 x"
        f"{v['kernel_launches']}" for n, v in lr.items()), flush=True)
    print("[summary] roi_batch at B=32, 224x224: " + ", ".join(
        f"{m} {r['ms']:.3f} ms (host route {r['host_ms']:.1f} ms)"
        for m, r in result["roi"].items()), flush=True)
    pf = result["recompute"]
    print(f"[summary] path F: seeds recomputed from stage 1's snapshot "
          f"(step {pf['seeder_step']}), median step "
          f"{per_epoch(pf['train'], 'median_step_ms')} ms, data wait "
          f"{per_epoch(pf['train'], 'data_wait_ms_per_step')} ms/step, "
          f"test MaxBoxAcc@50 {pf['test_best_loc']['maxboxacc_50']:.2f}; "
          f"cli/train.main {pf['wall_s']:.1f} s; total "
          f"{result['seconds']:.1f} s", flush=True)
    ph, pi, sv = result["recipe_yaml"], result["f_cl"], result["solve"]
    print(f"[summary] path H (--config ytov1_stage2_tcam.yaml, landmarks, "
          f"im_rec, switch at 1): seed sources {'/'.join(ph['seed_sources'])}"
          f", {ph['student_reloads']} student reloads, median step "
          f"{per_epoch(ph['train'], 'median_step_ms')} ms, data wait "
          f"{per_epoch(ph['train'], 'data_wait_ms_per_step')} ms/step, "
          f"roi_batch in the student step median "
          f"{statistics.median(ph['roi_batch_ms']):.2f} ms, knm_build "
          f"{ph['launches']['knm_build']['kernel']} launches in "
          f"{ph['steps']} steps, test MaxBoxAcc@50 "
          f"{ph['test_best_loc']['maxboxacc_50']:.2f}", flush=True)
    print(f"[summary] path I (F_CL): median step "
          f"{per_epoch(pi['train'], 'median_step_ms')} ms, data wait "
          f"{per_epoch(pi['train'], 'data_wait_ms_per_step')} ms/step, "
          f"bilateral_exact {pi['launches']['bilateral_exact']['kernel']} "
          f"launches in {pi['steps']} steps, test MaxBoxAcc 30/50/70 "
          + "/".join(f"{pi['test_best_loc'][f'maxboxacc_{s}']:.2f}"
                     for s in (30, 50, 70))
          + ", evaluate gap " + "/".join(
              f"{g:.4f}" for g in pi["evaluate_gap"].values()), flush=True)
    pm = result["cbox"]
    print(f"[summary] path M (C_BOX, --config ytov1_cbox.yaml): median step "
          f"{per_epoch(pm['train'], 'median_step_ms')} ms (blur "
          f"{statistics.median(pm['blur_ms']):.2f}, classifier forward "
          f"{statistics.median(pm['classify_ms']):.2f} x 3, timed apart), "
          f"data wait "
          f"{per_epoch(pm['train'], 'data_wait_ms_per_step')} ms/step, "
          f"valid boxes {per_epoch(pm['train'], 'valid_box_share')}, test "
          f"MaxBoxAcc 30/50/70 " + "/".join(
              f"{pm['test_best_loc'][f'maxboxacc_{s}']:.2f}"
              for s in (30, 50, 70))
          + ", evaluate gap " + "/".join(
              f"{g:.4f}" for g in pm["evaluate_gap"].values())
          + f", peak {pm['peak_mem_gib']:.2f} GiB, bilateral_exact "
          f"{pm['launches']['bilateral_exact']['kernel']} launches; hold: "
          f"{pm['hold']['valid_boxes']} valid boxes, card vs CPU max error "
          f"{max(pm['hold']['errors'].values()):.3e}", flush=True)
    pj, pk, ue = (result["stage1_encoders"], result["tcam_vgg16"],
                  result["unet_encoders"])
    for enc, r in pj["runs"].items():
        print(f"[summary] path J {enc}/{r['pooling']}: median step "
              f"{per_epoch(r['train'], 'median_step_ms')} ms, data wait "
              f"{per_epoch(r['train'], 'data_wait_ms_per_step')} ms/step, "
              f"test MaxBoxAcc 30/50/70 " + "/".join(
                  f"{r['test_best_loc'][f'maxboxacc_{s}']:.2f}"
                  for s in (30, 50, 70))
              + (", evaluate gap " + "/".join(
                  f"{g:.4f}" for g in pj["evaluate_gap"].values())
                 if enc == pj["evaluated"] else ""), flush=True)
    print(f"[summary] path K (TCAM on VGG16, center block): median step "
          f"{per_epoch(pk['train'], 'median_step_ms')} ms, data wait "
          f"{per_epoch(pk['train'], 'data_wait_ms_per_step')} ms/step, "
          f"bilateral_exact {pk['launches']['bilateral_exact']['kernel']} "
          f"launches in {pk['steps']} steps; UnetTCAM step " + ", ".join(
              f"{e} {r['step_ms']:.2f} ms" for e, r in ue.items()),
          flush=True)
    print("[summary] CAM methods (ms/image on the card, TF32 off): "
          + ", ".join(f"{m} {r['ms_per_image']:.3f} ({r['images']} x "
                      f"{r['samples']})"
                      for m, r in result["cam_methods"]["methods"].items()),
          flush=True)
    pn = result["mesh"]
    print(f"[summary] path N: world 1 over NCCL median step "
          f"{pn['world1']['train'][0]['median_step_ms']:.2f} ms (first-step "
          f"loss rel {pn['world1']['first_step_rel']:.2e} to path D's); "
          f"{MESH_WORLD} ranks over {pn['backend']} on {pn['cards']} "
          f"card(s): step ms " + " | ".join("/".join(
              f"{s['step_ms']:.2f}" for s in r["steps"]) for r in pn["ranks"])
          + ", all-reduce ms " + " | ".join("/".join(
              f"{m:.2f}" for m in r["allreduce_ms"]) for r in pn["ranks"])
          + ", peak " + "/".join(f"{r['peak_mem_gib']:.2f}"
                                 for r in pn["ranks"])
          + f" GiB; against 1 rank: loss rel "
          f"{max(pn['loss_rel'].values()):.2e}, updates "
          f"{pn['delta_rel']:.2e}, BN {pn['bn_rel']:.2e}; sharded eval "
          f"bit-equal", flush=True)
    po, pp, pim = result["demo"], result["image_sets"], result["import"]
    print("[summary] path O demo: " + ", ".join(
        f"{n} (threshold {r['threshold']:.3f}) {r['computed']} computed / "
        f"{r['reused']} reused, {r['model_frames_per_s']:.1f} frames/s in "
        f"the eval step, {r['frames_per_s']:.1f} end to end"
        for n, r in po["runs"].items())
        + f"; trainer visuals {po['visual_files']} files; single-largest "
        f"contour MaxBoxAcc@50 "
        f"{po['single_contour']['maxboxacc_50']:.2f}, host sweep "
        f"{po['single_contour']['timing']['sweep_ms_per_image']:.3f} "
        f"ms/image", flush=True)
    print(f"[summary] path P: CUB step "
          f"{pp['cub']['train']['median_step_ms']:.2f} ms, data wait "
          f"{pp['cub']['train']['data_wait_ms_per_step']:.2f} ms/step, "
          f"MaxBoxAcc@50 {pp['cub']['evaluate']['maxboxacc_50']:.2f}; "
          f"OpenImages PxAP {pp['openimages']['pxap']:.3f}; ILSVRC "
          f"{pp['ilsvrc']['buckets']} buckets, step "
          f"{pp['ilsvrc']['train']['median_step_ms']:.2f} ms, data wait "
          f"{pp['ilsvrc']['train']['data_wait_ms_per_step']:.2f} ms/step, "
          f"{pp['ilsvrc']['distinct']} train ids once; import logits rel "
          f"{pim['logits_rel']:.3e}; paths O, P and import "
          f"{result['paths_o_p_s']:.1f} s", flush=True)
    print(f"[summary] solve G=32 M=1024: lockstep {sv['lockstep_ms']:.3f} ms"
          f", cholesky_ex {sv['cholesky_ex_ms']:.3f} ms, rel "
          f"{sv['lockstep_vs_cholesky_rel']:.3e}", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
