"""Batched Otsu thresholds on tensors (port of ops/otsu.py): STOtsu over
unit bins (the CAM dump's rule) and skimage's 256-bin Otsu (the ROI's
re-threshold)."""
from __future__ import annotations

import torch


def otsu_threshold_255(x: torch.Tensor) -> torch.Tensor:
    """STOtsu threshold of each map of x (..., H, W), whose values are
    integer-valued floats in [0, 255] -> (...,): unit-width bins over
    [min, max], threshold = the left bin centre of the argmax inter-class
    variance; min == max returns min.  The sums are of integers, exact in
    any order."""
    lead = x.shape[:-2]
    v = x.reshape(-1, x.shape[-2] * x.shape[-1]).float()
    lo = v.amin(1, keepdim=True)
    hi = v.amax(1, keepdim=True)
    centers = torch.arange(256, dtype=torch.float32, device=v.device)
    idx = v.to(torch.int64).clamp(0, 255)
    hist = torch.zeros((v.shape[0], 256), dtype=torch.float32,
                       device=v.device)
    hist.scatter_add_(1, idx, torch.ones_like(v))
    hist = torch.where((centers >= lo) & (centers <= hi), hist, 0.0)
    w1 = torch.cumsum(hist, -1)
    w2 = torch.cumsum(hist.flip(-1), -1).flip(-1)
    m1 = torch.cumsum(hist * centers, -1) / w1.clamp_min(1e-12)
    m2 = (torch.cumsum((hist * centers).flip(-1), -1)
          / torch.cumsum(hist.flip(-1), -1).clamp_min(1e-12)).flip(-1)
    var12 = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    valid = (centers[:-1] >= lo) & (centers[:-1] < hi)
    var12 = torch.where(valid, var12, float("-inf"))
    t = centers[:-1][var12.argmax(-1)]
    return torch.where(lo[:, 0] == hi[:, 0], lo[:, 0], t).reshape(lead)


def otsu_threshold_batch(cams: torch.Tensor) -> torch.Tensor:
    """cams (B, H, W) in [0, 1] -> (B,) STOtsu thresholds over
    floor(cam * 255)."""
    return otsu_threshold_255(torch.floor(cams * 255.0))


_SCAN_BLOCK = 16


def _cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis (a multiple of 16 long) in the
    order of XLA's CPU lowering of jnp.cumsum: a running sum inside each
    block of 16, plus the running sum of the blocks' totals before it.
    Float sums depend on their order, and Otsu's argmax breaks its many
    exact ties on the last bit, so this order keeps the thresholds
    bit-equal to the JAX package's; it is deterministic on the card."""
    n = x.shape[-1]
    xb = x.reshape(*x.shape[:-1], n // _SCAN_BLOCK, _SCAN_BLOCK)
    cols = [xb[..., 0]]
    for i in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + xb[..., i])
    within = torch.stack(cols, -1)
    totals = within[..., -1]
    carry = [torch.zeros_like(totals[..., 0])]
    for k in range(1, n // _SCAN_BLOCK):
        carry.append(carry[-1] + totals[..., k - 1])
    return (within + torch.stack(carry, -1)[..., None]).reshape(x.shape)


def otsu_threshold_skimage255(x: torch.Tensor) -> torch.Tensor:
    """skimage.filters.threshold_otsu of each map of x (..., H, W), whose
    values are integers in [0, 255] (floor(cam * 255)) -> (...,).

    256 uniform bins over [min, max], membership by the integer rule
    k = (v - lo) * 256 // span (the last edge inclusive), threshold = the
    centre of the first bin of largest inter-class variance; a constant
    map gives 0.0 (every pixel is then foreground)."""
    lead = x.shape[:-2]
    v = x.reshape(-1, x.shape[-2] * x.shape[-1]).to(torch.int64)
    lo = v.min(-1).values
    hi = v.max(-1).values
    span = (hi - lo).clamp_min(1)
    k = ((v - lo[:, None]) * 256 // span[:, None]).clamp(0, 255)
    hist = torch.zeros((v.shape[0], 256), dtype=torch.float32,
                       device=v.device)
    hist.scatter_add_(1, k, torch.ones_like(k, dtype=torch.float32))
    step = span.to(torch.float32) / 256.0
    centers = (lo.to(torch.float32)[:, None]
               + (torch.arange(256, dtype=torch.float32, device=v.device)
                  + 0.5) * step[:, None])
    # bin 0 holds lo and bin 255 holds hi, so w1 and w2 are never zero
    w1 = _cumsum_blocked(hist)
    w2 = _cumsum_blocked(hist.flip(-1)).flip(-1)
    m1 = _cumsum_blocked(hist * centers) / w1
    m2 = (_cumsum_blocked((hist * centers).flip(-1))
          / _cumsum_blocked(hist.flip(-1))).flip(-1)
    var12 = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    t = centers[:, :-1].gather(1, var12.argmax(-1, keepdim=True))[:, 0]
    return torch.where(lo == hi, 0.0, t).reshape(lead)
