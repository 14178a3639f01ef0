"""Dump the stage-1 classifier's per-frame CAMs and Otsu ROI thresholds into
a CAM store for stage 2 (port of cli/dump_cams.py).

    python -m tcam_wsol_video_tpu_torch.cli.dump_cams --task STD_CL \\
        --data_root <root> --metadata_root <folds> --crop_size 224 \\
        --exp_dir <stage-1 experiment folder> --out <store> \\
        [--cam_size 28] [--device cpu]

Every frame of every train shot goes through the stage-1 classifier at
its eval_checkpoint_type snapshot: the whole frame resized to crop x crop
with Pillow's bilinear arithmetic (data/transforms.py; libjpeg decode on
the CPU, nvJPEG on the card), normalized (in the JAX dump's order for
--h2d_transfer: make_dump_step), and its CAM for the shot's
label resized on the device to cam_size x cam_size and clipped to [0, 1].
The classifier computes in --compute_dtype (default bfloat16, as the JAX
dump builds its model); its CAMs come out in float32: the fc-weight CAM
of a WGAP head (--method CAM), or the map of a head that builds them
(--method GAP / MaxPool / LogSumExpPool / WildCat, the built-in route).
The other methods of a WGAP head are refused with a ValueError that
names the method (JAX's dump sends them to the built-in route, which
fails on WGAP's missing maps).
The store gets one .npy per frame and roi_thresholds.txt (`dump_threshold_np`
of each CAM).  The host stores batch i and takes its thresholds while
batch i + 1 computes.  It runs on the card unless --device cpu is given;
without CUDA it raises.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.extractors import BUILTIN_CAM_METHODS
from tcam_wsol_video_tpu_torch.cli.train import (device_from, eval_dataset,
                                                 resolve_metadata_root)
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.image_route import route_for
from tcam_wsol_video_tpu_torch.data.transforms import (normalize_u8,
                                                       normalize_u8_scaled)
from tcam_wsol_video_tpu_torch.engine.steps import make_classifier_cam_fn
from tcam_wsol_video_tpu_torch.metrics.otsu_np import otsu_np
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.ops.interpolate import (_linear_matrix,
                                                       resize_bilinear)


def dump_threshold_np(cam_lo: np.ndarray, crop_size: int) -> float:
    """The stored ROI threshold of one low-resolution CAM, in [0, 1]:
    STOtsu over floor(255 x the CAM upsampled to crop x crop with
    align_corners=True), divided by 255."""
    mh = _linear_matrix(cam_lo.shape[0], crop_size, True)
    mw = _linear_matrix(cam_lo.shape[1], crop_size, True)
    full = mh @ np.asarray(cam_lo, np.float64) @ mw.T
    return otsu_np(np.floor(full * 255.0)) / 255.0


def load_pixels(paths: Sequence[str], crop: int, device: torch.device
                ) -> torch.Tensor:
    """The dump's frames, resized whole to crop x crop: (N, crop, crop, 3)
    uint8 on `device`, by its image route (data/image_route.py)."""
    return route_for(device).load_resized_u8(list(paths), (crop, crop),
                                             device)


def train_frames(args: TCAMConfig) -> Tuple[str, List[Tuple[str, int]]]:
    """(data root, [(frame id, label)]) of every frame of every train
    shot, shot by shot."""
    ds = eval_dataset(args, KeyChain(args.seed), constants.TRAINSET)
    md = ds.md
    frames = []
    for sid in md.image_ids:
        frames.extend((f, md.labels[sid])
                      for f in ds.index_of_frames.get(sid, [sid]))
    return os.path.join(args.data_root, args.dataset), frames


def load_classifier(args: TCAMConfig, exp_dir: str, device: torch.device):
    """The stage-1 STDClassifier at exp_dir's eval_checkpoint_type
    snapshot -> (model, snapshot step, snapshot folder)."""
    chpt_dir = os.path.join(exp_dir, args.eval_checkpoint_type)
    step, payload = ckpt.load_best_model(chpt_dir)
    if payload is None:
        raise FileNotFoundError(f"no best-model snapshot under {chpt_dir}")
    model = create_model_from_args(args, override_arch_for_classifier=True,
                                   device=device)
    ckpt.load_components(model, payload["components"])
    return model, step, chpt_dir


def make_dump_step(model, args: TCAMConfig, cam_size: int):
    """dump_step(uint8 frames (B, crop, crop, 3), labels (B,)) -> CAMs
    (B, cam_size, cam_size) in [0, 1] on the frames' device.  The frames
    are normalized as the JAX dump does under args.h2d_transfer: v / 255
    then (v - mean) / std for float32, (v - 255 mean) / (255 std) for
    uint8."""
    cam_fn = make_classifier_cam_fn(model, args)
    normalize = (normalize_u8_scaled if args.h2d_transfer == "uint8"
                 else normalize_u8)

    def dump_step(frames: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        cams = cam_fn(normalize(frames), labels)
        cams = resize_bilinear(cams[..., None], (cam_size, cam_size),
                               align_corners=False)[..., 0]
        return cams.clamp(0.0, 1.0)

    return dump_step


def _to_host(cams: torch.Tensor):
    """Start the copy of a batch's CAMs to the host -> (host tensor, event
    to wait for, or None on the CPU)."""
    if cams.device.type == "cpu":
        return cams, None
    host = torch.empty(cams.shape, dtype=cams.dtype, pin_memory=True)
    host.copy_(cams, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def dump_cams(args: TCAMConfig, exp_dir: str, out_dir: str,
              cam_size: int = 28, batch_size: int = 32,
              device="cuda") -> Dict:
    """Writes the store; returns {'store', 'step' (of the snapshot),
    'n_frames', 'seconds', 'frames_per_s', 'host_s' (saving the CAMs and
    their thresholds)}."""
    device = torch.device(device)
    if args.method not in ((constants.METHOD_CAM,)
                           + BUILTIN_CAM_METHODS):
        raise ValueError(
            f"the dump stores the CAM method's or a built-in head's maps; "
            f"method {args.method} is neither")
    args = resolve_metadata_root(args)
    data_root, frames = train_frames(args)
    model, step, _ = load_classifier(args, exp_dir, device)
    dump_step = make_dump_step(model, args, cam_size)
    store = CamStore(out_dir)
    thresholds: Dict[str, float] = {}
    host_s = 0.0

    def process(pending) -> None:
        nonlocal host_s
        host, done, chunk = pending
        if done is not None:
            done.synchronize()
        t0 = time.perf_counter()
        cams = host.numpy()
        for j, (fid, _) in enumerate(chunk):
            store.save_cam(fid, cams[j])
            thresholds[fid] = dump_threshold_np(cams[j], args.crop_size)
        host_s += time.perf_counter() - t0

    t_start = time.perf_counter()
    pending: Optional[tuple] = None
    for s in range(0, len(frames), batch_size):
        chunk = frames[s:s + batch_size]
        pixels = load_pixels([os.path.join(data_root, f) for f, _ in chunk],
                             args.crop_size, device)
        labels = torch.tensor([lab for _, lab in chunk], dtype=torch.int64)
        if len(chunk) < batch_size:
            # the tail batch keeps the batch shape: tile its last frame
            pad = batch_size - len(chunk)
            pixels = torch.cat([pixels, pixels[-1:].expand(pad, -1, -1, -1)])
            labels = torch.cat([labels, labels[-1:].expand(pad)])
        if device.type == "cuda":
            labels = labels.pin_memory().to(device, non_blocking=True)
        host, done = _to_host(dump_step(pixels, labels))
        if pending is not None:
            process(pending)
        pending = (host, done, chunk)
    if pending is not None:
        process(pending)
    store.save_thresholds(thresholds)
    seconds = time.perf_counter() - t_start
    return {"store": store, "step": step, "n_frames": len(frames),
            "seconds": seconds, "frames_per_s": len(frames) / seconds,
            "host_s": host_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns dump_cams' record of the run."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--exp_dir", required=True,
                       help="stage-1 experiment folder")
    extra.add_argument("--out", required=True, help="CAM store folder")
    extra.add_argument("--cam_size", type=int, default=28)
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = device_from(ns.device)
    logger = ExpLogger(ns.exp_dir)
    out = dump_cams(args, ns.exp_dir, ns.out, cam_size=ns.cam_size,
                    device=device)
    logger.log(f"dumped {out['n_frames']} train CAMs of the "
               f"{args.eval_checkpoint_type} snapshot (step {out['step']}) "
               f"into {ns.out} in {out['seconds']:.2f} s")
    return out


if __name__ == "__main__":
    main()
