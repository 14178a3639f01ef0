"""Paired geometry of (image, raw image, stored CAM) (port of
data/transforms.py).

Train: resize to (resize, resize), random crop, random horizontal flip;
eval: resize to (crop, crop).  The image loaders apply it to the pixels
(data/native_loader.py, data/nvjpeg_loader.py) and the dataset to the CAM
with the same draws (WSOLVideoDataset.cam_roi_for).  `PairedTransform`
holds the geometry; the draws come from the pipeline's KeyChain streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.core.constants import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
from tcam_wsol_video_tpu_torch.ops.interpolate import _linear_matrix


@dataclass(frozen=True)
class PairedTransform:
    resize_size: int
    crop_size: int
    train: bool
    hflip_p: float = 0.5


def _resize_cam(cam: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """torch-interpolate-style bilinear (align_corners=False) on (H, W)."""
    mh = _linear_matrix(cam.shape[0], size[0], False)
    mw = _linear_matrix(cam.shape[1], size[1], False)
    return mh @ cam @ mw.T


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> normalized."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (img - mean) / std
