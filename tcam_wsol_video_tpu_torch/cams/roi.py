"""Host ROI extraction for the batch side (port of cams/roi.py
roi_one_cam_np, ROI_ALL branch): skimage-Otsu threshold over
floor(cam * 255) (or a stored threshold), blobs = cam * 255 >= threshold,
the whole image as the box."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.metrics.otsu_np import otsu_skimage_np


def roi_one_cam_np(cam: np.ndarray, roi_method: str = constants.ROI_ALL,
                   p_min_area_roi: float = 0.05,
                   thresh: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cam (H, W) in [0, 1] -> (roi int32, bbox mask float32, box)."""
    if roi_method != constants.ROI_ALL:
        raise NotImplementedError(f"ROI method {roi_method} is not ported")
    h, w = cam.shape
    th = (otsu_skimage_np(np.floor(cam * 255.0)) if thresh is None
          else float(thresh))
    roi = (cam * 255.0 >= th).astype(np.int32)
    box = np.array([0.0, 0.0, w - 1.0, h - 1.0], np.float32)
    x0, y0, x1, y1 = box.astype(int)
    mask = np.zeros((h, w), np.float32)
    mask[y0:y1, x0:x1] = 1.0
    return roi, mask, box
