"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from the sources in this checkout (one nvcc
     per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes and a few edge shapes (for the exact filter, the
     edges of its tile-pair schedule too), with the stated tolerances, and
     check that two launches of the exact filter at batch 32 are
     bit-equal;
  3. path A, the stage-2 TCAM recipe of the end-to-end script (UnetTCAM
     on ResNet-50, 224 px, batch 32, exact dense CRF; fp32 weights and
     activations with TF32 cuDNN convolutions, random weights from SEED):
     STEPS train steps and one eval step, with launch counts reset just
     before;
  4. the same first step with every convolution in full fp32, its loss
     terms against path A's;
  5. at batch 2, the exact CRF loss value and gradient through the kernel
     against the same quantities from the plain version;
  6. path B, the production stage-2 recipe (landmark CRF, M = 1024, the
     build_knm kernel for K_nm and K_mm): STEPS train steps and one eval
     step; then the same first step from the same state through the fused
     Nystrom kernels (TCAM_FUSED_LANDMARKS=1), its loss terms against path
     B's; every Cholesky factorization checked (info == 0);
  7. path C, the eval step with the mean-field CRF refinement (5
     iterations of the exact kernel) at batch 32;
  8. at batch 2, the landmark CRF loss value and gradient through the
     kernels (both routes) against the plain versions;
  9. path D, the stage-2 trainer end to end through the CLI a user runs
     (cli/train.main with the stage-2 flags of the end-to-end script at
     bs 32 / 224 px, 2 epochs, random weights): a synthetic YTOv1-sized
     set written with nvJPEG, its round trip held against the source
     frames, a stand-in CAM store in place of stage 1; the data layer
     (nvJPEG decode on the card, CAM fusion and ROI on the host), the
     train step with the exact CRF kernel once per step, the ELB anneal,
     validation with the host box sweep (MaxBoxAcc), model selection and
     the test split at the best snapshots; launch counts reset just
     before;
 10. time each kernel (and the exact filter's per-call spread and
     scratch), its plain version and its bound at the main paths' shapes,
     fail if a kernel reads under its bound, hold kernel and plain version
     together there, and print the kernel table.
The sources build first: one nvcc per CUDA source (the two kernel files
and the nvJPEG codec) and g++ for native/boxsweep.cpp, all started
together.  The last line is {"ok": true, "device": {...}}.  Details go to
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


def landmark_inputs(gen, b, h, w, sigma_xy, m_req, k=2):
    """Centred features, landmark features and indices, values."""
    from tcam_wsol_video_tpu_torch.ops.crf import _landmark_grid_indices
    feats, vals = filter_inputs(gen, b, h, w, sigma_xy, k)
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


def compare_nystrom(name, feats, fm, idx, vals):
    """Pass 1 against its plain version, the fused filter and the whole
    landmark filter on both routes against nystrom_filter_plain."""
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import landmarks
    shape = list(feats.shape) + [fm.shape[1], vals.shape[2]]
    with linalg.record_info() as infos:
        rhs = landmarks.nystrom_rhs(feats, fm, vals)
        fused = landmarks.nystrom_filter(feats, vals, idx)
        api_fused = crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                        fused=True)
        api_build = crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                        fused=False)
        torch.cuda.synchronize()
        want = landmarks.nystrom_filter_plain(feats, vals, idx)
    check(all(int(i.abs().max()) == 0 for i in infos),
          f"{name}: a Cholesky factorization failed")
    rows = [_rel_row("nystrom_rhs", name, rhs,
                     landmarks.nystrom_rhs_plain(feats, fm, vals), shape,
                     FILTER_RTOL),
            _rel_row("nystrom_out", name, fused, want, shape, LMK_RTOL),
            _rel_row("landmark_filter_fused", name, api_fused, want,
                     shape, LMK_RTOL),
            _rel_row("landmark_filter_build_route", name, api_build,
                     want, shape, LMK_RTOL)]
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
    return rows


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


def build_main_path(seed: int, production: bool = False):
    """The recipe's model, optimizer, steps, batch and seeder generator
    (production: the production stage-2 recipe, landmark CRF); two builds
    from one seed start from the same state."""
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
            else stage2_tcam_recipe)(seed=seed)
    kc = KeyChain(seed)
    torch.manual_seed(seed)
    model = create_model_from_args(args, device="cuda")
    opt = build_optimizer(args, model, args.lr)
    state = TrainState(model, opt, elb_t=args.elb_init_t)
    master = get_loss_tcam(args)
    train_step = make_train_step(master, args, seeder_cfg_from_args(args))
    eval_step = make_cam_eval_step(model, args)
    host = synthetic_batch(kc.numpy_rng("chip_smoke", "batch"), args)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gen = kc.key("chip_smoke", "seeder", device="cuda")
    return (args, model, opt, state, train_step, eval_step, batch, gen,
            master.switches(0))


def phase_main_path(seed: int, steps: int, profile: bool) -> dict:
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

    (args, model, opt, state, train_step, eval_step, batch, gen,
     switches) = build_main_path(seed)

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
            print(f"[train] step {i}: " + " ".join(
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
          "path A: a plain version ran")
    print(f"[eval] cams {tuple(cams.shape)} logits {tuple(logits.shape)} "
          f"{eval_ms:.2f} ms; cam range [{cams.min().item():.4f}, "
          f"{cams.max().item():.4f}]", flush=True)
    print(f"[launches] bilateral kernel={launches['kernel']} "
          f"plain={launches['plain']}", flush=True)
    crop = args.crop_size
    check(tuple(cams.shape) == (args.batch_size, crop, crop),
          f"eval cams shape {tuple(cams.shape)}")
    check(tuple(logits.shape) == (args.batch_size, args.num_classes),
          f"eval logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(cams).all()) and cams.min().item() >= 0.0
          and cams.max().item() <= 1.0, "eval cams outside [0, 1]")
    check(bool(torch.isfinite(logits).all()), "eval logits not finite")
    check(launches["kernel"] >= steps, "the CRF kernel did not run on the "
          f"main path ({launches['kernel']} launches)")
    check(launches["plain"] == 0, "the plain filter ran on the main path")

    n_params = sum(p.numel() for p in model.parameters())
    n_frozen = sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith(("encoder.", "classification_head.")))
    print(f"[model] {n_params} parameters, {n_frozen} of them frozen "
          f"(encoder + head under freeze_cl)", flush=True)
    after = records[1:] if len(records) > 1 else records
    out = {"steps": records, "eval_ms": eval_ms, "launches": launches,
           "params": n_params, "frozen_params": n_frozen,
           "median_step_ms": statistics.median(r["step_ms"] for r in after),
           "median_crf_kernel_ms": statistics.median(
               r["crf_kernel_ms"] for r in after),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        out["profile"] = profile_step(train_step, state, batch, switches,
                                      gen)
    del state, model, opt, batch
    torch.cuda.empty_cache()
    return out


def profile_step(train_step, state, batch, switches, gen) -> dict:
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
    print(f"[profile] kernel time {total:.2f} ms in a {wall_ms:.2f} ms step "
          f"under the profiler (device idle {100 * idle:.1f}%); top:",
          flush=True)
    for r in rows[:12]:
        print(f"[profile]   {r['device_ms']:9.3f} ms  x{r['calls']:<4d}"
              f" {r['name'][:90]}", flush=True)
    return {"kernel_ms": total, "wall_ms": wall_ms, "idle_share": idle,
            "rows": rows[:60]}


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
    """Path B (build route), then its first step on the fused route."""
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    (args, model, _, state, train_step, eval_step, batch, gen,
     switches) = build_main_path(seed, production=True)
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
                                          switches, gen)
    del state, model, batch
    torch.cuda.empty_cache()

    # the same first step from the same state through the fused kernels
    (_, model, _, state, train_step, _, batch, gen,
     switches) = build_main_path(seed, production=True)
    with fused_landmarks(True), linalg.record_info() as infos, \
            CrfTimer(crf, "gaussian_filter_apply_landmarks") as timer:
        reset_counts()
        fused = run_steps(train_step, state, batch, switches, gen, steps,
                          timer, "path B fused")
        fused_launches = read_counts()
    check_infos(infos, "path B fused")
    print(f"[path B fused] launches {fused_launches}", flush=True)
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
            out["fused"]["profile"] = profile_step(train_step, state, batch,
                                                   switches, gen)
    # path C on this model: eval with the mean-field CRF refinement
    out["path_c"] = phase_post_process(args, model, batch)
    del state, model, batch
    torch.cuda.empty_cache()
    return out


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
def path_d_flags(root: str) -> list:
    """The stage-2 command of cmds/e2e_synth224_tpu.sh (freeze_cl from
    config_yaml/ytov1_stage2_tcam.yaml), 2 epochs, random weights, the
    stand-in CAM store, no rolling checkpoints."""
    return [
        "--dataset", "YouTube-Objects-v1.0", "--data_root", root,
        "--metadata_root", os.path.join(root, "folds"), "--crop_size", "224",
        "--resize_size", "256", "--cam_curve_interval", "0.01",
        "--num_workers", "4", "--task", "TCAM", "--arch", "UnetTCAM",
        "--batch_size", "32", "--eval_batch_size", "32",
        "--max_epochs", str(PATH_D_EPOCHS), "--lr", "0.01",
        "--freeze_cl", "True", "--seed", str(SEED),
        "--elb_init_t", "1.0", "--elb_max_t", "10.0", "--elb_mulcoef",
        "1.01", "--sl_tc", "True", "--sl_tc_lambda", "1.0", "--sl_tc_min",
        "1", "--sl_tc_max", "1", "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6",
        "--sl_tc_min_p", "0.1", "--sl_tc_seed_tech", "seed_weighted",
        "--sl_tc_use_roi", "True", "--sl_tc_roi_method", "roi_all",
        "--sl_tc_roi_min_size", "0.05", "--sl_tc_knn", "1",
        "--sl_tc_knn_mode", "before", "--sl_tc_knn_t", "0.0",
        "--crf_tc", "True", "--crf_tc_lambda", "2e-9",
        "--crf_tc_sigma_rgb", "15.0", "--crf_tc_sigma_xy", "100.0",
        "--crf_tc_scale", "1.0", "--max_sizepos_tc", "True",
        "--max_sizepos_tc_lambda", "0.01",
        "--std_cams_folder", os.path.join(root, "cams"),
        "--checkpoint_save", "0", "--outd", os.path.join(root, "exps"),
        "--exp_id", "s2", "--log_every", "0", "--device", "cuda"]


def _eval_line(tag: str, r: dict) -> str:
    return (f"[{tag}] {r['n_images']} images, {r['images_per_s']:.1f} "
            f"images/s, forward {r['forward_ms_per_batch']:.2f} ms/batch, "
            f"native sweep {r['sweep_ms_per_image']:.3f} ms/image; "
            f"classification {r['classification']:.2f}, MaxBoxAcc "
            f"30/50/70 {r['maxboxacc_30']:.2f}/{r['maxboxacc_50']:.2f}/"
            f"{r['maxboxacc_70']:.2f}")


def phase_trainer(seed: int) -> dict:
    """Path D: the synthetic set (nvJPEG), its JPEG round trip against the
    source frames, the stand-in CAM store, then cli/train.main with the
    counts reset just before."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.synthetic import (
        make_stand_in_cam_store, make_synthetic_dataset)
    from tcam_wsol_video_tpu_torch.losses.elb import update_t

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
    print(f"[path D] synthetic set {PATH_D_DATA} written in {gen_s:.2f} s "
          f"(nvJPEG, quality 95); round trip of {len(errs)} frames: mean "
          f"|decoded - source| median {statistics.median(errs):.3f}, max "
          f"{max(errs):.3f} levels (tol {JPEG_MEAN_ABS_TOL})", flush=True)
    check(max(errs) <= JPEG_MEAN_ABS_TOL,
          f"nvJPEG round trip is {max(errs):.3f} levels off the source")
    t0 = time.perf_counter()
    make_stand_in_cam_store(synth["metadata_root"], os.path.join(root,
                                                                 "cams"),
                            seed=seed)
    store_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = cli_train.main(path_d_flags(root))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    train = out["records"]["train"]
    evals = out["records"]["eval"]
    steps = sum(r["steps"] for r in train)
    check(len(train) == PATH_D_EPOCHS and all(r["steps"] == 5
                                              for r in train),
          f"path D: steps per epoch {[r['steps'] for r in train]}, not 5")
    t = 1.0
    for r in train:
        t = update_t(t, 1.01, 10.0)
        print(f"[path D epoch {r['epoch']}] wall {r['wall_ms']:.1f} ms, "
              f"{r['steps']} steps, median step {r['median_step_ms']:.2f} "
              f"ms (CUDA events), data wait {r['data_wait_ms_per_step']:.2f}"
              f" ms/step (pixels {r['data_pixels_ms_per_step']:.2f}, CAM "
              f"side {r['data_cams_ms_per_step']:.2f}); loss "
              f"{r['loss']:.6g}; ELB t after the epoch "
              f"{r['elb_t']:.6f}; the steps' spans cover "
              f"{100 * sum(r['step_ms']) / r['wall_ms']:.1f}% of the epoch",
              flush=True)
        check(np.isfinite(r["loss"]), f"path D epoch {r['epoch']}: loss")
        check(r["elb_t"] == t, f"path D: ELB t {r['elb_t']} after epoch "
              f"{r['epoch']}, expected {t}")
    for i, e in enumerate(evals):
        when = (e["snapshot"] if e["snapshot"] else "before training"
                if i == 0 else f"after epoch {e['epoch']}")
        print(_eval_line(f"path D eval {e['split']} {when}", e), flush=True)
        check(e["n_images"] == 320, f"path D: {e['n_images']} images in "
              f"{e['split']}")
        check(all(0.0 <= e[f"maxboxacc_{s}"] <= 100.0 for s in (30, 50, 70)),
              "path D: MaxBoxAcc outside [0, 100]")
    check(constants.BEST_LOC in out["test"], "path D: no test evaluation "
          "at the best-localization snapshot")
    best = out["test"][constants.BEST_LOC]
    print(_eval_line("path D test best_localization",
                     {**best, **best["timing"]}), flush=True)
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
    shutil.rmtree(root)
    return {"wall_s": wall_s, "gen_s": gen_s, "store_s": store_s,
            "jpeg_round_trip_mean_abs": errs, "launches": launches,
            "steps": steps, "train": train, "eval": evals,
            "test_best_loc": {k: v for k, v in best.items()
                              if k != "curves"},
            "peak_mem_gib": peak}


# ------------------------------------------------------------ TF32 vs fp32
def phase_tf32_gap(seed: int, tf32_steps: list) -> dict:
    """The main path runs its cuDNN convolutions in TF32.  Rebuild the
    same starting state, run two steps with every convolution in full
    fp32, and hold the first step's loss terms against the main path's
    first step (same weights, batch and seeder noise)."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        (_, _, _, state, train_step, _, batch, gen,
         switches) = build_main_path(seed)
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
    a = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from tcam_wsol_video_tpu_torch.core import nativebuild
    from tcam_wsol_video_tpu_torch.ops.cuda import build

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
        host = pool.submit(nativebuild.build_all, ["boxsweep"], True)
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
    result["checks"] = phase_kernel_checks(SEED)
    result["bit_equal"] = check_bit_equal(SEED)
    result["checks"] += phase_landmark_checks(SEED)
    result["main_path"] = phase_main_path(SEED, STEPS, a.profile)
    result["tf32_gap"] = phase_tf32_gap(SEED, result["main_path"]["steps"])
    result["crf_parity"] = phase_crf_parity(SEED)
    result["production"] = phase_production(SEED, STEPS, a.profile)
    result["crf_landmark_parity"] = phase_landmark_parity(SEED)
    result["trainer"] = phase_trainer(SEED)
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
        # path D, this slice's main path; path A's count beside it
        "launches": result["trainer"]["launches"]["bilateral_exact"][
            "kernel"],
        "launches_path_a": result["main_path"]["launches"]["kernel"],
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
            "replaces": ("tcam_wsol_video_tpu/ops/pallas/landmarks.py:248"
                         if name == "knm_build" else
                         "tcam_wsol_video_tpu/ops/pallas/landmarks.py:137"),
            "launches": launches, "max_abs_err": max_err(name),
            "ms": lmk[f"{key}_ms"], "plain_ms": lmk[f"{key}_plain_ms"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "library_ms": None})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({**result, "kernels": kernels}, f, indent=1)
    mp = result["main_path"]
    print(f"[summary] path A: median step {mp['median_step_ms']:.2f} ms, "
          f"CRF kernel in step {mp['median_crf_kernel_ms']:.2f} ms, peak "
          f"{mp['peak_mem_gib']:.2f} GiB", flush=True)
    print(f"[summary] path B: median step {prod['median_step_ms']:.2f} ms, "
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
          f"{tr['test_best_loc']['maxboxacc_50']:.2f} (IoU 50); "
          f"cli/train.main {tr['wall_s']:.1f} s; total "
          f"{result['seconds']:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
