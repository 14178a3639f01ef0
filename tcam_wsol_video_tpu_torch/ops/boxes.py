"""Box helpers (port of ops/boxes.py resize_bbox and mask_to_bbox)."""
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
