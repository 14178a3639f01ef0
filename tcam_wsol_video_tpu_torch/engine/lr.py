"""Epoch learning-rate schedules with a min-lr floor (port of
engine/lr.py; same scheduler names):

- "mystep": lr gamma^(epoch // step_size), floored at min_lr;
- "step": the same without the floor;
- "constant": lr;
- "cosine": min_lr + (lr - min_lr) (1 + cos(pi min(epoch, t_max) /
  t_max)) / 2, held at its end after t_max;
- "mycosine": max(lr coef (1 + cos((epoch - 1) pi / max_epochs)), min_lr);
- "multistep": lr gamma^(milestones passed).

The trainer sets the optimizer's rate once per epoch.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence


def step_lr(base_lr: float, step_size: int, gamma: float,
            min_lr: float) -> Callable[[int], float]:
    def fn(epoch: int) -> float:
        return max(base_lr * (gamma ** (epoch // step_size)), min_lr)
    return fn


def cosine_lr(base_lr: float, t_max: int, min_lr: float
              ) -> Callable[[int], float]:
    def fn(epoch: int) -> float:
        return min_lr + (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * min(epoch, t_max) / t_max)) / 2.0
    return fn


def mycosine_lr(base_lr: float, coef: float, max_epochs: int,
                min_lr: float) -> Callable[[int], float]:
    def fn(epoch: int) -> float:
        return max(base_lr * coef * (
            1.0 + math.cos((epoch - 1) * math.pi / float(max_epochs))),
            min_lr)
    return fn


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float
                 ) -> Callable[[int], float]:
    ms = sorted(int(m) for m in milestones)

    def fn(epoch: int) -> float:
        return base_lr * (gamma ** bisect.bisect_right(ms, epoch))
    return fn


def build_lr_fn(args) -> Callable[[int], float]:
    if args.lr_scheduler == "mystep":
        return step_lr(args.lr, args.step_size, args.gamma, args.min_lr)
    if args.lr_scheduler == "step":
        return step_lr(args.lr, args.step_size, args.gamma, 0.0)
    if args.lr_scheduler == "constant":
        return lambda epoch: args.lr
    if args.lr_scheduler == "cosine":
        return cosine_lr(args.lr, args.t_max, args.min_lr)
    if args.lr_scheduler == "mycosine":
        return mycosine_lr(args.lr, args.lr_coef, args.max_epochs,
                           args.min_lr)
    if args.lr_scheduler == "multistep":
        return multistep_lr(args.lr, args.lr_milestones, args.gamma)
    raise ValueError(args.lr_scheduler)
