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
    """'head' for classifier-rate parameters (classification_head, and
    encoder.layer4* on ResNet), 'base' otherwise."""
    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        head = keys[0] == "classification_head" or (
            encoder_name.startswith("resnet") and len(keys) >= 2
            and keys[0] == "encoder" and keys[1].startswith("layer4"))
        labels[name] = "head" if head else "base"
    return labels


class DecayAllSGD(torch.optim.SGD):
    """torch SGD that also decays (and moves the momentum of) parameters
    that received no gradient, as the optax chain does."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        return super().step(closure)


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
