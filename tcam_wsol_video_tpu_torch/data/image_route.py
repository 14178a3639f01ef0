"""The image route of a device: libjpeg on the host for a CPU device
(data/native_loader.py, bit-equal to the JAX package's native path),
nvJPEG on the card for a CUDA device (data/nvjpeg_loader.py).  Neither
route falls back to the other.

Both modules offer the same functions, each returning tensors on the
device (the host route's are zero-copy views of its numpy arrays):
- load_batch(paths, resize, crop, xs, ys, flips, device): decode, resize
  to (resize, resize), crop at (ys, xs), flip and normalize -> (normalized,
  raw) (N, crop, crop, 3) float32;
- decode_resize_u8(paths, resize, device): (N, resize, resize, 3) uint8,
  the frames of the decoded-frame cache and of the card-resident feed;
- load_resized_u8(paths, size, device): whole frames resized as Pillow's
  BILINEAR does, (N, h, w, 3) uint8 (the CAM dump's pixels);
- frame_cache(budget_mb, device): the decoded-frame cache, whose
  load_batch(paths, resize, crop, xs, ys, flips) is load_batch's;
- encode(img, quality, device): (h, w, 3) uint8 RGB -> baseline JPEG
  bytes.
"""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.data import native_loader, nvjpeg_loader


def route_for(device):
    """The image route module of `device`: native_loader for the CPU,
    nvjpeg_loader for a card."""
    if torch.device(device).type == "cpu":
        return native_loader
    return nvjpeg_loader
