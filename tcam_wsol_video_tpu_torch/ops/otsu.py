"""Batched Otsu thresholds on tensors (port of ops/otsu.py)."""
from __future__ import annotations

import torch


def otsu_threshold_255(x: torch.Tensor) -> torch.Tensor:
    """STOtsu threshold of one map of integer-valued floats in [0, 255]:
    unit-width bins over [min, max], threshold = the left bin centre of the
    argmax inter-class variance; min == max returns min."""
    v = x.reshape(-1).float()
    lo, hi = v.min(), v.max()
    centers = torch.arange(256, dtype=torch.float32, device=v.device)
    idx = v.to(torch.int64).clamp(0, 255)
    hist = torch.zeros(256, dtype=torch.float32, device=v.device)
    hist = hist.index_add(0, idx, torch.ones_like(v))
    hist = torch.where((centers >= lo) & (centers <= hi), hist, 0.0)
    w1 = torch.cumsum(hist, 0)
    w2 = torch.cumsum(hist.flip(0), 0).flip(0)
    m1 = torch.cumsum(hist * centers, 0) / w1.clamp_min(1e-12)
    m2 = (torch.cumsum((hist * centers).flip(0), 0)
          / torch.cumsum(hist.flip(0), 0).clamp_min(1e-12)).flip(0)
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    valid = (centers[:-1] >= lo) & (centers[:-1] < hi)
    var12 = torch.where(valid, var12, float("-inf"))
    t = centers[:-1][torch.argmax(var12)]
    return torch.where(lo == hi, lo, t)


def otsu_threshold_batch(cams: torch.Tensor) -> torch.Tensor:
    """cams (B, H, W) in [0, 1] -> (B,) STOtsu thresholds over
    floor(cam * 255)."""
    x = torch.floor(cams * 255.0)
    return torch.stack([otsu_threshold_255(c) for c in x])
