"""BatchNorm over the global batch of the dp group (what flax's BatchNorm
computes under JAX's global program, whose batch statistics cover the
whole sharded batch).

forward: each rank takes its element count, mean and centred sum of
squares M2 = sum (x - mean)^2 per channel (in float32, or float64 for a
float64 input); one all-gather over the group gives every rank's, and
the pairwise combine (Chan, Golub and LeVeque) gives the global mean and
the biased variance M2 / N: flax's batch statistics, without the
cancellation of its one-pass E[x^2] - E[x]^2 in float32 for channels
whose mean is large against their spread (the one-rank route, torch's
batch norm, has none either); then
(x - mean) (rsqrt(var + eps) w) + b, returned in x's dtype.
backward: one all-reduce of sum(dy) and sum(dy x_hat) gives the input's
gradient over the global batch; the weight's and bias's gradients stay
this rank's sums (the gradient all-reduce adds the ranks').

torch's SyncBatchNorm is not used: it refuses CPU tensors, and it folds
the unbiased variance where flax folds the biased one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

_DIMS = (0, 2, 3)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _bc(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        acc = _acc_dtype(x)
        xa = x.to(acc)
        c = x.shape[1]
        n_local = float(x.numel() // c)
        mean_r = xa.mean(_DIMS)
        m2_r = ((xa - _bc(mean_r)) ** 2).sum(_DIMS)
        mine = torch.cat([torch.full((1,), n_local, dtype=acc,
                                     device=x.device), mean_r, m2_r])
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        stats = torch.stack(parts)                   # (ranks, 1 + 2 C)
        counts, means, m2s = stats[:, :1], stats[:, 1:c + 1], stats[:, c + 1:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)) / n
        rstd = torch.rsqrt(var + eps)
        mul = rstd * weight.to(acc)
        out = (xa - _bc(mean)) * _bc(mul) + _bc(bias.to(acc))
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.n = n
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, weight = ctx.saved_tensors
        acc = _acc_dtype(x)
        dya = dy.to(acc)
        xhat = (x.to(acc) - _bc(mean)) * _bc(rstd)
        sum_dy = dya.sum(_DIMS)
        sum_dy_xhat = (dya * xhat).sum(_DIMS)
        dx = None
        if ctx.needs_input_grad[0]:
            c = x.shape[1]
            red = torch.cat([sum_dy, sum_dy_xhat])
            dist.all_reduce(red, group=ctx.group)
            n = ctx.n
            dx = _bc(rstd * weight.to(acc)) * (
                dya - _bc(red[:c] / n) - xhat * _bc(red[c:] / n))
            dx = dx.to(x.dtype)
        dw = sum_dy_xhat.to(weight.dtype) if ctx.needs_input_grad[1] \
            else None
        db = sum_dy.to(weight.dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float, group
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(normalized x in x's dtype, the global mean, the global biased
    variance) of x (B, C, H, W) over the group's concatenated batch."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps, group)
