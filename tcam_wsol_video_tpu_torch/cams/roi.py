"""ROI extraction from CAMs (port of cams/roi.py): threshold -> blobs ->
region selection -> box.

- threshold: skimage's 256-bin Otsu over floor(cam * 255) (0 on a constant
  map), or a stored threshold in [0, 255];
- blobs = cam * 255 >= threshold;
- ROI_ALL keeps every blob and the whole image as its box; ROI_LARGEST
  keeps the largest 4-connected component; ROI_H_DENSITY keeps the densest
  (CAM mass / area) unless its area is under p_min_area_roi of the image,
  then the largest; with at most one component the blobs stay as they
  are; ties go to the first component (the lowest label);
- box: the selected region's covering box with exclusive ends clamped to
  size - 1; an empty region gives [0, 0, 0, 0] (the reference's empty
  contour);
- mask: box_mask[y0:y1, x0:x1] = 1 (exclusive ends; so ROI_ALL's mask
  leaves the last row and column out, as the reference's does).

`roi_batch` is the tensor route (batched, on the CAMs' device: min
propagation labels, 64 component slots, JAX's device path); `roi_one_cam_np`
the host route (scipy labels, float64 densities, JAX's host path).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.metrics.otsu_np import otsu_skimage_np
from tcam_wsol_video_tpu_torch.ops.boxes import mask_to_bbox
from tcam_wsol_video_tpu_torch.ops.connected_components import (
    component_stats, label, label_np)
from tcam_wsol_video_tpu_torch.ops.otsu import otsu_threshold_skimage255


def _check_method(roi_method: str) -> None:
    if roi_method not in constants.ROI_SELECT:
        raise ValueError(f"ROI method {roi_method!r} is not one of "
                         f"{constants.ROI_SELECT}")


def _box_mask_exclusive(h: int, w: int, box: torch.Tensor) -> torch.Tensor:
    """mask[y0:y1, x0:x1] = 1 of boxes (B, 4) -> (B, h, w) float32."""
    ys = torch.arange(h, dtype=torch.float32, device=box.device)
    xs = torch.arange(w, dtype=torch.float32, device=box.device)
    x0, y0, x1, y1 = (box[:, i, None] for i in range(4))
    inside_y = (ys >= y0) & (ys < y1)
    inside_x = (xs >= x0) & (xs < x1)
    return (inside_y[:, :, None] & inside_x[:, None, :]).to(torch.float32)


def roi_batch(cams: torch.Tensor, roi_method: str = constants.ROI_ALL,
              p_min_area_roi: float = 0.05,
              threshs: Optional[torch.Tensor] = None,
              max_components: int = 64, cc_iters: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ROIs of cams (B, H, W) in [0, 1] on their device.  threshs (B,):
    stored thresholds in [0, 255], else Otsu's.  Returns (roi (B, H, W)
    int32, box mask (B, H, W) float32, box (B, 4) float32)."""
    _check_method(roi_method)
    b, h, w = cams.shape
    if threshs is None:
        th = otsu_threshold_skimage255(torch.floor(cams * 255.0))
    else:
        th = threshs.to(torch.float32)
    blobs = (cams * 255.0 >= th[:, None, None]).to(torch.int32)
    if roi_method == constants.ROI_ALL:
        box = torch.zeros((b, 4), device=cams.device)
        box[:, 2] = w - 1.0
        box[:, 3] = h - 1.0
        return blobs, _box_mask_exclusive(h, w, box), box

    lab = label(blobs, num_iters=cc_iters)
    areas, masses, comp = component_stats(lab, cams, max_components)
    area_rank = torch.where(areas > 0, areas, float("-inf"))
    chosen = area_rank.argmax(1)          # the first largest
    if roi_method == constants.ROI_H_DENSITY:
        density = masses / areas.clamp_min(1e-12)
        density = torch.where(areas > 0, density, float("-inf"))
        densest = density.argmax(1)
        small = (areas.gather(1, densest[:, None])[:, 0]
                 < h * w * p_min_area_roi)
        chosen = torch.where(small, chosen, densest)
    n_comp = (areas > 0).sum(1)
    roi = torch.where((n_comp <= 1)[:, None, None], blobs,
                      (comp == chosen[:, None, None]).to(torch.int32))
    box = mask_to_bbox(roi)
    # the contour convention: exclusive ends clamped to the image
    box[:, 2] = torch.clamp(box[:, 2] + 1, max=w - 1)
    box[:, 3] = torch.clamp(box[:, 3] + 1, max=h - 1)
    empty = roi.sum((1, 2)) == 0
    box = torch.where(empty[:, None], 0.0, box)
    return roi, _box_mask_exclusive(h, w, box), box


def roi_one_cam(cam: torch.Tensor, roi_method: str = constants.ROI_ALL,
                p_min_area_roi: float = 0.05,
                thresh: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """roi_batch of one (H, W) cam: (roi, box mask, box (4,))."""
    th = None if thresh is None else torch.as_tensor(
        thresh, dtype=torch.float32, device=cam.device).reshape(1)
    roi, mask, box = roi_batch(cam[None], roi_method, p_min_area_roi, th)
    return roi[0], mask[0], box[0]


def roi_one_cam_np(cam: np.ndarray, roi_method: str = constants.ROI_ALL,
                   p_min_area_roi: float = 0.05,
                   thresh: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host ROI of one cam (H, W) in [0, 1] (scipy labels) -> (roi int32,
    box mask float32, box (4,) float32)."""
    _check_method(roi_method)
    h, w = cam.shape
    th = (otsu_skimage_np(np.floor(cam * 255.0)) if thresh is None
          else float(thresh))
    blobs = (cam * 255.0 >= th).astype(np.int32)
    if roi_method == constants.ROI_ALL:
        roi = blobs
        box = np.array([0.0, 0.0, w - 1.0, h - 1.0], np.float32)
    else:
        lab = label_np(blobs)
        ids = [i for i in np.unique(lab) if i != 0]
        if len(ids) <= 1:
            roi = blobs
        else:
            areas = {i: float((lab == i).sum()) for i in ids}
            chosen = max(areas, key=areas.get)
            if roi_method == constants.ROI_H_DENSITY:
                dens = {i: float((cam * (lab == i)).sum()) / areas[i]
                        for i in ids}
                densest = max(dens, key=dens.get)
                if areas[densest] >= h * w * p_min_area_roi:
                    chosen = densest
            roi = (lab == chosen).astype(np.int32)
        if roi.sum() == 0:
            box = np.zeros((4,), np.float32)
        else:
            ys, xs = np.nonzero(roi)
            box = np.array([xs.min(), ys.min(), min(xs.max() + 1, w - 1),
                            min(ys.max() + 1, h - 1)], np.float32)
    x0, y0, x1, y1 = box.astype(int)
    mask = np.zeros((h, w), np.float32)
    mask[y0:y1, x0:x1] = 1.0
    return roi, mask, box
