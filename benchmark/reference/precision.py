"""Rounding in the reference's convolutions and dense layers: fp32 (the
reference), or a lower precision (the control, and the bf16 witness).

A layer rounds three things, as a low-precision train step stores them:
- its operands, input and weight (`round_to`): the forward sees the
  rounded values, and the backward passes the gradient through the
  rounding unchanged, as a low-precision matmul's backward would;
- its output (`activation`): the forward rounds the activation it hands
  on, and the backward rounds the gradient that arrives at it, which is
  the operand of the layer's data- and weight-gradient products.
bf16: rounded to bfloat16.  fp8: scaled per tensor to float8_e4m3's range
(448) and rounded to it, in both directions (the current-scaling recipe
of fp8 training)."""
from __future__ import annotations

import torch

MODES = ("fp32", "bf16", "fp8")
E4M3_MAX = 448.0


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if mode == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"precision {mode!r} is not one of {MODES}")


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp32":
        return x
    y = _round(x.detach(), mode)
    return x + (y - x.detach())


class _Both(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode), None


def activation(y: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp32":
        return y
    return _Both.apply(y, mode)
