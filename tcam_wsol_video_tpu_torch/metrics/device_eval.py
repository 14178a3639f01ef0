"""Approximate localization counters on the device (port of
metrics/device_eval.py; on_device_eval).

For every threshold tau at once, each image's box is the largest
contiguous run of over-threshold rows by columns (ops/boxes.
sweep_largest_run_boxes), scored by IoU against its padded GT boxes.  The
counters sum over images per (sigma, tau); MaxBoxAcc is the best tau's
share.  Exact on single-blob maps, close to the contour protocol on
several blobs: for model selection during training only; reported numbers
come from the exact sweep (metrics/native_sweep, metrics/device_sweep).
"""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.ops.boxes import (iou_matrix,
                                                 sweep_largest_run_boxes)


def _counters_one(cam: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, taus: torch.Tensor,
                  sigmas: torch.Tensor) -> torch.Tensor:
    """One image: cam (H, W) in [0, 1], gt_boxes (G, 4), gt_valid (G,),
    taus (T,), sigmas (S,) as fractions -> (S, T) float32 0/1."""
    boxes = sweep_largest_run_boxes(cam, taus)            # (T, 4)
    iou = torch.where(gt_valid[None, :], iou_matrix(boxes, gt_boxes), 0.0)
    best = iou.amax(1)                                    # (T,)
    return (best[None, :] >= sigmas[:, None]).to(torch.float32)


def batch_counters(cams: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, taus: torch.Tensor,
                   sigmas: torch.Tensor) -> torch.Tensor:
    """cams (B, H, W), gt_boxes (B, G, 4), gt_valid (B, G) -> the (S, T)
    correct counts summed over the batch."""
    out = torch.zeros((sigmas.shape[0], taus.shape[0]), dtype=torch.float32,
                      device=cams.device)
    for i in range(cams.shape[0]):
        out = out + _counters_one(cams[i], gt_boxes[i], gt_valid[i], taus,
                                  sigmas)
    return out


def max_box_acc(counters: torch.Tensor, count) -> torch.Tensor:
    """(S, T) counters and the image count -> (S,) MaxBoxAcc in percent."""
    return counters.amax(1) * 100.0 / count
