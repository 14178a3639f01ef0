"""Box helpers (port of ops/boxes.py): resize_bbox, mask_to_bbox, the
IoU matrix and the per-threshold single-box sweeps of the approximate
on-device eval counters (metrics/device_eval.py)."""
from __future__ import annotations

from typing import Tuple

import torch


def resize_bbox(box, image_size, resize_size) -> Tuple[int, int, int, int]:
    """Scale a box x0, y0, x1, y1 from image size (w, h) to (w', h');
    coordinates truncate to int after scaling, as the protocol's GT
    boxes do."""
    x0, y0, x1, y1 = (float(v) for v in box)
    w_ratio = resize_size[0] / float(image_size[0])
    h_ratio = resize_size[1] / float(image_size[1])
    return (int(x0 * w_ratio), int(y0 * h_ratio),
            int(x1 * w_ratio), int(y1 * h_ratio))


def mask_to_bbox(mask: torch.Tensor) -> torch.Tensor:
    """Covering boxes (x0, y0, x1, y1) of binary masks (B, H, W) ->
    (B, 4) float32, inclusive ends; an all-zero mask gives [0, 0, 0, 0]
    (the reference's empty-contour box)."""
    b, h, w = mask.shape
    any_row = (mask > 0).any(2)
    any_col = (mask > 0).any(1)
    rows = torch.arange(h, device=mask.device)
    cols = torch.arange(w, device=mask.device)
    y0 = torch.where(any_row, rows, h).amin(1)
    y1 = torch.where(any_row, rows, -1).amax(1)
    x0 = torch.where(any_col, cols, w).amin(1)
    x1 = torch.where(any_col, cols, -1).amax(1)
    box = torch.stack([x0, y0, x1, y1], 1).to(torch.float32)
    return torch.where(any_row.any(1)[:, None], box, 0.0)


def iou_matrix(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """+1-pixel IoU of boxes (A, 4) against (B, 4) -> (A, B) float32; a
    pair whose union is <= 0 scores 0."""
    a = box_a[:, None, :].to(torch.float32)
    b = box_b[None, :, :].to(torch.float32)
    min_x = torch.maximum(a[..., 0], b[..., 0])
    min_y = torch.maximum(a[..., 1], b[..., 1])
    max_x = torch.minimum(a[..., 2], b[..., 2])
    max_y = torch.minimum(a[..., 3], b[..., 3])
    inter = ((max_x - min_x + 1).clamp_min(0.0)
             * (max_y - min_y + 1).clamp_min(0.0))
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    denom = area_a + area_b - inter
    iou = inter / torch.where(denom <= 0, 1.0, denom)
    return torch.where(denom <= 0, 0.0, iou)


def _profiles(cam: torch.Tensor, taus: torch.Tensor):
    """The protocol's uint8 rendering q = floor(cam 255) of cam (H, W),
    its cutoffs floor(tau max q) (T,), and the rows and columns (T, H),
    (T, W) holding a pixel over each cutoff (cv2's strict threshold)."""
    q = torch.floor(cam.clamp(0.0, 1.0) * 255.0)
    thr = torch.floor(taus.to(torch.float32) * q.max())
    row_on = q.amax(1)[None, :] > thr[:, None]
    col_on = q.amax(0)[None, :] > thr[:, None]
    return row_on, col_on


def _finish_boxes(x0, y0, x1, y1, h: int, w: int,
                  empty: torch.Tensor) -> torch.Tensor:
    """(T, 4) boxes with boundingRect's exclusive ends clamped to the
    image, [0, 0, 0, 0] where the level is empty."""
    x1 = torch.clamp(x1 + 1, max=w - 1)
    y1 = torch.clamp(y1 + 1, max=h - 1)
    boxes = torch.stack([x0, y0, x1, y1], 1).to(torch.float32)
    return torch.where(empty[:, None], 0.0, boxes)


def sweep_covering_boxes(cam: torch.Tensor, taus: torch.Tensor
                         ) -> torch.Tensor:
    """For each threshold tau, the box covering the pixels of the uint8
    rendering over int(tau max) (the single-box analogue of the contour
    protocol).  cam (H, W) in [0, 1], taus (T,) -> (T, 4) float32."""
    h, w = cam.shape
    row_on, col_on = _profiles(cam, taus)
    rows = torch.arange(h, device=cam.device)
    cols = torch.arange(w, device=cam.device)
    y0 = torch.where(row_on, rows, h).amin(1)
    y1 = torch.where(row_on, rows, -1).amax(1)
    x0 = torch.where(col_on, cols, w).amin(1)
    x1 = torch.where(col_on, cols, -1).amax(1)
    return _finish_boxes(x0, y0, x1, y1, h, w, ~row_on.any(1))


def _largest_run(on: torch.Tensor):
    """The first longest run of True per row of on (T, N): (start, end)
    inclusive, (T,) each; an empty row gives start 0, end -1."""
    n = on.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=on.device)
    last_false = torch.cummax(torch.where(on, -1, idx[None, :]), 1).values
    runlen = idx[None, :] - last_false
    end = runlen.argmax(1)
    length = runlen.amax(1)
    return end - length + 1, torch.where(length > 0, end, -1)


def sweep_largest_run_boxes(cam: torch.Tensor, taus: torch.Tensor
                            ) -> torch.Tensor:
    """For each threshold, the box of the largest contiguous run of rows
    and of columns over the cutoff (the dominant component's analogue of
    sweep_covering_boxes).  cam (H, W), taus (T,) -> (T, 4) float32."""
    h, w = cam.shape
    row_on, col_on = _profiles(cam, taus)
    y0, y1 = _largest_run(row_on)
    x0, x1 = _largest_run(col_on)
    return _finish_boxes(x0, y0, x1, y1, h, w, ~row_on.any(1))
