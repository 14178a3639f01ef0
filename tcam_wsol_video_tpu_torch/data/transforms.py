"""Paired geometry of (image, raw image, stored CAM) (port of
data/transforms.py), and the CAM dump's pixel route.

Train: resize to (resize, resize), random crop, random horizontal flip;
eval: resize to (crop, crop).  The image loaders apply it to the pixels
(data/native_loader.py, data/nvjpeg_loader.py) and the dataset to the CAM
with the same draws (WSOLVideoDataset.cam_roi_for).  `PairedTransform`
holds the geometry; the draws come from the pipeline's KeyChain streams.

The CAM dump resizes whole frames as the JAX dump does, with Pillow's
`Image.resize(..., BILINEAR)`: `pil_bilinear_resize` repeats Pillow's
arithmetic without Pillow (the triangle filter, whose support widens with
the downscale factor; coefficients in double, then 22-bit fixed point; a
horizontal then a vertical integer pass, each rounded and clipped to
uint8).  It is integer arithmetic on tensors, so it gives the same bits on
the CPU and on the card.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

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


def to_device(v, device: torch.device) -> torch.Tensor:
    """A host array or sequence as a tensor on `device`; to the card from
    pinned memory, asynchronously (a copy from pageable memory would wait
    for the work already queued on the stream)."""
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        return v.to(device)
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def crop_flip(x: torch.Tensor, crop: int, ys, xs, flips, rows=None
              ) -> torch.Tensor:
    """The window of each map of x (N, r, r[, C]) at row ys[i], column
    xs[i], mirrored left-right where flips[i] -> (B, crop, crop[, C]), as
    one gather on x's device.  rows (B,) picks the maps (all N, in order,
    when None)."""
    dev = x.device
    ys, xs, flips = (to_device(v, dev) for v in (ys, xs, flips))
    ar = torch.arange(crop, device=dev)
    r_idx = ys.long()[:, None] + ar
    c_idx = xs.long()[:, None] + torch.where(flips.bool()[:, None],
                                             crop - 1 - ar, ar)
    n = (torch.arange(x.shape[0], device=dev) if rows is None
         else to_device(rows, dev).long())
    return x[n[:, None, None], r_idx[:, :, None], c_idx[:, None, :]]


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> normalized."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (img - mean) / std


@functools.lru_cache(maxsize=None)
def imagenet_stats(device: torch.device, scale: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) x scale as float32 tensors on `device`, computed in
    float32 on the host and copied there once (a copy at every call would
    make the host wait for the card's queue)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * scale
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32) * scale
    return mean.to(device), std.to(device)


def normalize_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> normalized float32, in the JAX dump's order:
    v / 255, then (v - mean) / std."""
    mean, std = imagenet_stats(img.device)
    return (img.float() / 255.0 - mean) / std


def normalize_u8_scaled(raw: torch.Tensor) -> torch.Tensor:
    """Pixels in [0, 255] (uint8 or float) -> normalized float32 in the
    h2d_transfer=uint8 order of the JAX steps and dump:
    (v - 255 mean) / (255 std)."""
    mean, std = imagenet_stats(raw.device, 255.0)
    return (raw.to(torch.float32) - mean) / std


_PIL_BITS = 22          # Pillow's PRECISION_BITS for 8-bit images


@functools.lru_cache(maxsize=32)
def _pil_bilinear_taps(n_in: int, n_out: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for the
    triangle filter along one axis: (idx, weight), each (n_out, ksize),
    the source index of every tap and its fixed-point weight.  Taps past
    a window's end weigh 0 (their index is clamped into range)."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    idx = np.zeros((n_out, ksize), np.int64)
    weight = np.zeros((n_out, ksize), np.int32)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            if ww != 0.0:
                v /= ww
            weight[xx, x] = (int(-0.5 + v * (1 << _PIL_BITS)) if v < 0
                             else int(0.5 + v * (1 << _PIL_BITS)))
        idx[xx] = np.minimum(xmin + np.arange(ksize), n_in - 1)
    return idx, weight


def _pil_pass(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One integer pass of Pillow's resampler along `axis` of an int32
    tensor of levels in [0, 255]."""
    idx, weight = _pil_bilinear_taps(x.shape[axis], n_out)
    idx = torch.from_numpy(idx).to(x.device)
    weight = torch.from_numpy(weight).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = n_out
    out_shape = list(x.shape)
    out_shape[axis] = n_out
    acc = torch.full(out_shape, 1 << (_PIL_BITS - 1), dtype=torch.int32,
                     device=x.device)
    for t in range(idx.shape[1]):
        acc += x.index_select(axis, idx[:, t]) * weight[:, t].view(shape)
    return (acc >> _PIL_BITS).clamp_(0, 255)


def pil_bilinear_resize(frames: torch.Tensor, size: Tuple[int, int]
                        ) -> torch.Tensor:
    """Pillow's Image.resize((w, h), BILINEAR) of each (h0, w0, 3) uint8
    frame of `frames` (N, h0, w0, 3) -> (N, h, w, 3) uint8, on the frames'
    device.  An axis whose size does not change is left as it is."""
    h, w = int(size[0]), int(size[1])
    x = frames.to(torch.int32)
    if x.shape[2] != w:
        x = _pil_pass(x, w, 2)
    if x.shape[1] != h:
        x = _pil_pass(x, h, 1)
    return x.to(torch.uint8)
