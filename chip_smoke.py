"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from the sources in this checkout (nvcc);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes and a few edge shapes, with the stated tolerance;
  3. drive the main path: the stage-2 TCAM recipe (UnetTCAM on ResNet-50,
     224 px, batch 32, fp32 weights and activations with TF32 cuDNN
     convolutions, random weights from SEED) for STEPS train steps and
     one eval step, with launch counts reset just before;
  4. the same first step with every convolution in full fp32, its loss
     terms against the main path's;
  5. at batch 2, the CRF loss value and gradient through the kernel
     against the same quantities from the plain version;
  6. time each kernel, its plain version and its bound at the main path's
     shapes, hold kernel and plain version together there, and print the
     kernel table.
The last line is {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.  There is no CPU fallback: without CUDA the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
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
    """Times every call of the bilateral wrapper with CUDA events."""

    def __init__(self, module):
        self.module = module
        self.orig = module.gaussian_filter_apply_batched
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
        self.module.gaussian_filter_apply_batched = timed
        return self

    def __exit__(self, *exc):
        self.module.gaussian_filter_apply_batched = self.orig

    def take_ms(self) -> float:
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return ms


def build_main_path(seed: int):
    """The recipe's model, optimizer, steps, batch and seeder generator;
    two builds from one seed start from the same state."""
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import stage2_tcam_recipe
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import (make_cam_eval_step,
                                                        make_train_step)
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args

    args = stage2_tcam_recipe(seed=seed)
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

    bilateral.counts.reset()
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
    together there (at B = 32 this is the main path's shape)."""
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    feats, vals = filter_inputs(gen, b, crop, crop, 100.0)
    kernel_ms = cuda_time_ms(
        lambda: bilateral.gaussian_filter_apply_batched(feats, vals), 3)
    plain_ms = cuda_time_ms(
        lambda: bilateral.gaussian_filter_apply_plain(feats, vals), 1)
    check_row = compare_filter(f"B{b}_{crop}x{crop}_D5_K2_timed", feats,
                               vals, single=b == 1)
    bound = filter_bound(b, crop * crop, feats.shape[2], vals.shape[2])
    print(f"[time] bilateral B={b} P={crop * crop}: kernel {kernel_ms:.3f} ms"
          f", plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
          f"(mufu {bound['mufu_ms']:.3f}, fp32 {bound['fp32_ms']:.3f}, "
          f"bytes {bound['bytes_ms']:.4f})", flush=True)
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "check": check_row,
            **bound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (torch.profiler)")
    a = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    print(f"[precision] cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    built = bilateral.build(force=True)
    print(f"[build] bilateral.cu in {built['seconds']:.1f} s", flush=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)

    result = {"device": smi, "build_s": built["seconds"],
              "ptxas": built["log"]}
    result["checks"] = phase_kernel_checks(SEED)
    result["main_path"] = phase_main_path(SEED, STEPS, a.profile)
    result["tf32_gap"] = phase_tf32_gap(SEED, result["main_path"]["steps"])
    result["crf_parity"] = phase_crf_parity(SEED)
    timing = phase_timing(SEED, 32, 224)
    result["timing"] = timing
    # the single-image function (the B = 1 case), off the main path
    result["timing_single_image"] = phase_timing(SEED, 1, 224)
    result["checks"] += [timing["check"],
                         result["timing_single_image"]["check"]]
    result["seconds"] = time.perf_counter() - t0

    kernels = [{
        "name": "bilateral_exact",
        "route": "cuda",
        "source": "tcam_wsol_video_tpu_torch/csrc/bilateral.cu",
        "replaces": "tcam_wsol_video_tpu/ops/pallas/bilateral.py:159",
        "launches": result["main_path"]["launches"]["kernel"],
        "max_abs_err": max(r["max_abs_err"] for r in result["checks"]),
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({**result, "kernels": kernels}, f, indent=1)
    mp = result["main_path"]
    print(f"[summary] median step {mp['median_step_ms']:.2f} ms, CRF kernel "
          f"in step {mp['median_crf_kernel_ms']:.2f} ms, peak "
          f"{mp['peak_mem_gib']:.2f} GiB, total {result['seconds']:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
