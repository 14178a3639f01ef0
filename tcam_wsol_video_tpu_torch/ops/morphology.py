"""Flat-kernel morphology as max/min pools (port of ops/morphology.py).
SAME padding over the last two axes: ((k-1)//2, k//2) per axis."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) float -> max over a k x k window, padded with -inf."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    lo, hi = (k - 1) // 2, k // 2
    y = F.pad(y, (lo, hi, lo, hi), value=float("-inf"))
    y = F.max_pool2d(y, k, stride=1)
    return y.reshape(lead + y.shape[-2:])


def dilate(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Dilation with a flat ksize x ksize kernel; x (..., H, W) float or
    int (ints go through float32, exact for the 0/1 masks used here)."""
    if ksize <= 1:
        return x
    if x.is_floating_point():
        return _window_max(x, ksize)
    return _window_max(x.float(), ksize).to(x.dtype)


def erode(x: torch.Tensor, ksize: int, iterations: int = 1) -> torch.Tensor:
    """Erosion with a flat ksize x ksize kernel (max-pool of -x)."""
    if ksize <= 1 or iterations <= 0:
        return x
    out = x.float()
    for _ in range(iterations):
        out = -_window_max(-out, ksize)
    return out if x.is_floating_point() else out.to(x.dtype)
