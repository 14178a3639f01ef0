"""Demo videos: each frame's CAM overlay with its GT (green) and predicted
(red) box, one Motion-JPEG AVI a video (port of cli/demo_video.py).

    python -m tcam_wsol_video_tpu_torch.cli.demo_video --exp_dir <exp> \\
        --out <folder> --task TCAM --arch UnetTCAM --data_root <root> \\
        --metadata_root <folds> [--split test-video-demo] [--tau 0.5] \\
        [--max_videos 4] [--fps 8] [--reuse_threshold 0] [--device cpu]

It loads the eval_checkpoint_type snapshot of --exp_dir, runs the split's
frames through the eval step in batches of --eval_batch_size and writes
<out>/<class>_data_<video>.avi for the first --max_videos videos (a
video is the first three parts of a frame id), frames in id order.  The
predicted box is the single largest contour's at --tau
(metrics/wsol.scoremap_to_boxes).  JAX writes mp4v .mp4 through cv2; the
port writes .avi (viz/wsol_viz.build_demo_video: nvJPEG on the card,
libjpeg on the CPU).

--reuse_threshold > 0 turns on change-based inference
(engine/temporal_reuse.py): a frame whose mean absolute pixel difference
from its video's last computed frame is below it reuses that frame's
CAM.  The frames that need the model are moved to the front of the batch,
and the batch keeps its one shape (the rest zeros), so one cuDNN plan
serves every batch, as JAX keeps one compiled shape.  It runs on the card
unless --device cpu is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import collections
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cli.train import (device_from, eval_dataset,
                                                 resolve_metadata_root)
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.engine.steps import (dequantize_cams_np,
                                                    make_cam_eval_step)
from tcam_wsol_video_tpu_torch.engine.temporal_reuse import FrameReusePlanner
from tcam_wsol_video_tpu_torch.metrics.wsol import scoremap_to_boxes
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.viz import wsol_viz


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns {'written': the AVI paths, 'computed' / 'reused': frames,
    'compute_s': seconds in the eval step and its readback, 'frames':
    frames seen}."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--exp_dir", required=True)
    extra.add_argument("--out", required=True)
    extra.add_argument("--split", default=constants.TESTSET_VIDEO_DEMO)
    extra.add_argument("--tau", type=float, default=0.5)
    extra.add_argument("--max_videos", type=int, default=4)
    extra.add_argument("--fps", type=int, default=8)
    extra.add_argument("--reuse_threshold", type=float, default=0.0,
                       help="skip the model for frames whose mean |delta| "
                            "from the last computed frame of the video is "
                            "below this ([0, 255] units; 0 = off)")
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = device_from(ns.device)
    args = resolve_metadata_root(args)
    logger = ExpLogger(ns.exp_dir, is_master=True)

    chpt_dir = os.path.join(ns.exp_dir, args.eval_checkpoint_type)
    _, payload = ckpt.load_best_model(chpt_dir)
    if payload is None:
        raise FileNotFoundError(f"no best-model snapshot under {chpt_dir}")
    kc = KeyChain(args.seed)
    ds = eval_dataset(args, kc, ns.split)
    # one pass: no decoded-frame cache
    pipe = DataPipeline(ds, args.eval_batch_size, kc, shuffle=False,
                        device=device)
    model = create_model_from_args(args, device=device)
    ckpt.load_components(model, payload["components"])
    eval_step = make_cam_eval_step(model, args)
    generator = kc.key("demo", device=device)

    planner = FrameReusePlanner(ns.reuse_threshold)
    frames_by_video: Dict[str, List[tuple]] = collections.OrderedDict()
    compute_s, seen = 0.0, 0
    alpha = args.alpha_visu / 255.0
    for batch in pipe.epoch(0):
        ids = list(batch["image_id"])
        vids = ["/".join(iid.split("/")[:3]) for iid in ids]
        raws = batch["raw_img"].float().cpu().numpy()
        valid = batch["valid"].cpu().numpy()
        compute_rows, reuse_from = planner.plan(vids, raws)
        cams_np = np.zeros(raws.shape[:3], np.float32)
        sub = None
        if compute_rows:
            t0 = time.perf_counter()
            rows = torch.as_tensor(compute_rows, dtype=torch.int64,
                                   device=device)
            sel = torch.zeros_like(batch["image"])
            sel[:len(compute_rows)] = batch["image"][rows]
            labels = torch.zeros_like(batch["label"])
            labels[:len(compute_rows)] = batch["label"][rows]
            cams, _ = eval_step(sel, targets=labels, generator=generator)
            sub = dequantize_cams_np(cams.cpu().numpy())
            compute_s += time.perf_counter() - t0
        planner.resolve_rows(vids, compute_rows, reuse_from, sub, cams_np)
        for i, iid in enumerate(ids):
            if not valid[i]:
                continue
            seen += 1
            vid = vids[i]
            if (len(frames_by_video) >= ns.max_videos
                    and vid not in frames_by_video):
                continue
            pred_boxes, _ = scoremap_to_boxes(cams_np[i], [ns.tau],
                                              multi_contour=False)
            frame = wsol_viz.cam_overlay(raws[i], cams_np[i], alpha=alpha)
            frame = wsol_viz.draw_boxes(frame, ds.eval_gt_boxes(iid),
                                        wsol_viz.GT_COLOR)
            frame = wsol_viz.draw_boxes(frame, pred_boxes[0],
                                        wsol_viz.PRED_COLOR)
            frames_by_video.setdefault(vid, []).append((iid, frame))

    if ns.reuse_threshold > 0.0:
        logger.log(f"change-based inference: {planner.n_computed} computed,"
                   f" {planner.n_reused} reused "
                   f"({100.0 * planner.reuse_fraction:.1f}% of the model "
                   "calls saved)")
    os.makedirs(ns.out, exist_ok=True)
    written = []
    for vid, frames in frames_by_video.items():
        frames.sort(key=lambda t: t[0])
        path = os.path.join(ns.out, vid.replace("/", "_") + ".avi")
        wsol_viz.build_demo_video([f for _, f in frames], path, fps=ns.fps,
                                  device=device)
        written.append(path)
        logger.log(f"wrote {path} ({len(frames)} frames)")
    return {"written": written, "computed": planner.n_computed,
            "reused": planner.n_reused, "compute_s": compute_s,
            "frames": seen}


if __name__ == "__main__":
    main()
