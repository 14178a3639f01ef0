"""The loss terms of the benchmark's configurations, in fp32.

- cl: the mean softmax cross-entropy of the logits (STD_CL).
- self_learning: the mean cross-entropy of the decoder's two-channel
  logits over the seeded pixels (1 for an unseeded batch's 0).
- crf: the dense CRF energy -sum(s * W s) / B of the softmax maps s, with
  W_ij = exp(-||f_i - f_j||^2 / 2) over f = (x, y) / sigma_xy and
  rgb / sigma_rgb, the diagonal included; W s is computed densely, a block
  of rows at a time, with no approximation.  Its gradient treats W s as a
  constant times two (W is symmetric): d/ds = -2 W s / B.
- max_size_positive: the extended log-barrier on minus each channel's
  summed probability, averaged over the batch, the two channels' mean.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

CRF_BLOCK_ROWS = 4096


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    return F.cross_entropy(logits.float(), labels.long())


def seeded_cross_entropy(fcams: torch.Tensor, seeds: torch.Tensor,
                         ignore: int) -> torch.Tensor:
    valid = seeds != ignore
    logp = torch.log_softmax(fcams.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, seeds, 0).long()[..., None]
                       )[..., 0]
    return (torch.where(valid, nll, 0.0).sum()
            / valid.sum().to(torch.float32).clamp_min(1))


def crf_features(raw: torch.Tensor, sigma_rgb: float, sigma_xy: float
                 ) -> torch.Tensor:
    """raw (B, H, W, 3) in [0, 255] -> (B, HW, 5): x, y, r, g, b scaled,
    centred per image (W depends on differences only)."""
    b, h, w, _ = raw.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=raw.device),
        torch.arange(w, dtype=torch.float64, device=raw.device),
        indexing="ij")
    xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1) / sigma_xy
    f = torch.cat([xy.expand(b, h * w, 2),
                   raw.reshape(b, h * w, 3).double() / sigma_rgb], -1)
    return (f - f.mean(1, keepdim=True)).float()


def dense_filter(feats: torch.Tensor, vals: torch.Tensor,
                 block: int = CRF_BLOCK_ROWS) -> torch.Tensor:
    """(W v) for feats (B, P, D), vals (B, P, K): fp32, TF32 off, one block
    of rows at a time."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.empty_like(vals)
        for i in range(feats.shape[0]):
            f, v = feats[i], vals[i]
            sq = (f * f).sum(-1)
            for r0 in range(0, f.shape[0], block):
                fr = f[r0:r0 + block]
                d2 = (sq[r0:r0 + block, None] + sq[None, :]
                      - 2.0 * (fr @ f.T)).clamp_min_(0.0)
                out[i, r0:r0 + block] = torch.exp_(d2.mul_(-0.5)) @ v
                del d2
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class _CrfEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, probs):
        b, h, w, k = probs.shape
        ws = dense_filter(feats, probs.reshape(b, h * w, k).float()
                          ).reshape(probs.shape)
        ctx.save_for_backward(ws)
        return -(probs * ws).sum() / float(b)

    @staticmethod
    def backward(ctx, g):
        (ws,) = ctx.saved_tensors
        return None, -2.0 * g * ws / float(ws.shape[0])


def crf(fcams: torch.Tensor, raw: torch.Tensor, sigma_rgb: float,
        sigma_xy: float, feats: Optional[torch.Tensor] = None):
    probs = torch.softmax(fcams.float(), dim=-1)
    if feats is None:
        feats = crf_features(raw, sigma_rgb, sigma_xy)
    return _CrfEnergy.apply(feats, probs)


def elb(fx: torch.Tensor, t: float) -> torch.Tensor:
    """Extended log-barrier of f(x) <= 0, mean-reduced."""
    fx = fx.float()
    log_branch = -(1.0 / t) * torch.log((-fx).clamp_min(1e-30))
    lin_branch = t * fx - (1.0 / t) * float(
        torch.log(torch.tensor(1.0 / (t * t)))) + 1.0 / t
    return torch.where(fx <= -1.0 / (t * t), log_branch, lin_branch).mean()


def max_size_positive(fcams: torch.Tensor, t: float) -> torch.Tensor:
    probs = torch.softmax(fcams.float(), dim=-1)
    b = probs.shape[0]
    return 0.5 * sum(elb(-probs[..., c].reshape(b, -1).sum(-1), t)
                     for c in (0, 1))
