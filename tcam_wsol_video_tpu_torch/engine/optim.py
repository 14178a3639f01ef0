"""SGD with momentum, nesterov, weight decay and a classifier-rate group
(port of engine/optim.py).

The JAX optimizer is the optax chain decayed weights -> per-group scale
(lr_classifier_ratio on 'head') -> momentum trace -> -lr.  torch's SGD
with a per-group lr computes the same update (the chain is linear), except
that it skips parameters whose .grad is None, where
optax.add_decayed_weights decays every parameter.  Under freeze_cl the
encoder and head get no gradient but are still decayed by the JAX step,
so `step` hands such parameters a zero gradient first.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def param_group_labels(model: nn.Module, encoder_name: str
                       ) -> Dict[str, str]:
    """'head' for classifier-rate parameters (classification_head,
    DenseBoxNet's box_head, encoder.layer4* on ResNet and encoder.SPG_* on
    InceptionV3), 'base' otherwise."""
    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        enc = len(keys) >= 2 and keys[0] == "encoder"
        head = keys[0] in ("classification_head", "box_head") or (
            enc and encoder_name.startswith("resnet")
            and keys[1].startswith("layer4")) or (
            enc and encoder_name == "inceptionv3"
            and keys[1].startswith("SPG_"))
        labels[name] = "head" if head else "base"
    return labels


class DecayAllSGD(torch.optim.SGD):
    """torch SGD that also decays (and moves the momentum of) parameters
    that received no gradient, as the optax chain does.

    A group's lr may be a 0-d tensor (the chunked route's device scalar,
    engine/scan_train.py): torch's SGD reads a tensor rate back to the
    host, which a CUDA graph cannot capture, so then every group is
    updated here (_step_on_device) with torch's multi-tensor formula, the
    rate read on the device."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if not any(isinstance(g["lr"], torch.Tensor)
                   for g in self.param_groups):
            return super().step(closure)
        if closure is not None:
            raise ValueError("no closure with a device learning rate")
        for group in self.param_groups:
            self._step_on_device(group)
        return None

    def _step_on_device(self, group: dict) -> None:
        """torch's _multi_tensor_sgd on the group (weight decay, momentum,
        dampening, nesterov) at its 0-d tensor lr.  The last add, params -
        lr g, is an addcmul of the negated rate: a multiply-add, as
        torch's add with a float alpha."""
        params = group["params"]
        grads = [p.grad for p in params]
        wd, mom = group["weight_decay"], group["momentum"]
        damp = group["dampening"]
        if wd != 0:
            grads = torch._foreach_add(grads, params, alpha=wd)
        if mom != 0:
            bufs = []
            for p in params:
                st = self.state[p]
                if st.get("momentum_buffer") is None:
                    # a zero trace updates as torch's first step does
                    # (0 m + g = g; build_optimizer allows no dampening)
                    st["momentum_buffer"] = torch.zeros_like(p)
                bufs.append(st["momentum_buffer"])
            torch._foreach_mul_(bufs, mom)
            torch._foreach_add_(bufs, grads, alpha=1 - damp)
            if group["nesterov"]:
                torch._foreach_add_(grads, bufs, alpha=mom)
            else:
                grads = bufs
        neg_lr = -group["lr"]
        torch._foreach_addcmul_(params, [neg_lr] * len(params), grads)


def build_optimizer(args, model: nn.Module, lr: float) -> DecayAllSGD:
    if args.opt_name != "sgd":
        raise NotImplementedError(args.opt_name)
    if float(args.dampening) != 0.0:
        raise ValueError("the JAX optimizer has no dampening")
    labels = param_group_labels(model, args.encoder_name)
    params = dict(model.named_parameters())
    groups = [
        {"params": [params[n] for n, l in labels.items() if l == "base"],
         "lr": lr, "ratio": 1.0},
        {"params": [params[n] for n, l in labels.items() if l == "head"],
         "lr": lr * float(args.lr_classifier_ratio),
         "ratio": float(args.lr_classifier_ratio)},
    ]
    return DecayAllSGD(groups, lr=lr, momentum=args.momentum,
                       weight_decay=args.weight_decay,
                       nesterov=args.nesterov)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch schedule tick: each group runs at lr times its
    ratio."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["ratio"]
