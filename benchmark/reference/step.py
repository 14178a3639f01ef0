"""The reference's train steps: forward, the configuration's loss terms,
backward and the optimizer's update, in fp32 (or the control's rounding).

The optimizer is SGD with Nesterov momentum and L2 weight decay added to
the gradient, every parameter decayed (a frozen one too, with a zero
gradient), the classifier-rate group at lr x lr_classifier_ratio:
    d = g + wd p;  m = d (first step) or mu m + d;  p -= lr_group (d + mu m)
(torch.optim.SGD's arithmetic: the same rule with other roundings moves
three steps of the tiny test models apart by chaos alone.)
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import losses, seeder
from benchmark.reference.model import head_rate_params

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels in [0, 255] -> the model input."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=raw.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=raw.device)
    return (raw.float() / 255.0 - mean) / std


class SGD:
    """torch.optim.SGD over the recipe's two groups; every parameter takes
    a gradient (zero where the loss gives none), so every one decays."""

    def __init__(self, model: torch.nn.Module, opt: dict):
        named = dict(model.named_parameters())
        self.names = {id(p): n for n, p in named.items()}
        groups = [{"params": [p for n, p in named.items()
                              if head_rate_params(n) == head],
                   "lr": opt["lr"] * (opt["lr_classifier_ratio"] if head
                                      else 1.0)}
                  for head in (False, True)]
        self.opt = torch.optim.SGD(
            groups, lr=opt["lr"], momentum=opt["momentum"],
            weight_decay=opt["weight_decay"], nesterov=opt["nesterov"])

    @torch.no_grad()
    def step(self) -> None:
        for group in self.opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.opt.step()

    @property
    def momentum(self) -> Dict[str, torch.Tensor]:
        return {self.names[id(p)]: st["momentum_buffer"]
                for p, st in self.opt.state.items()}


def terms(task: str, out: dict, batch: dict, gumbel: Optional[torch.Tensor],
          loss_cfg: dict, elb_t: float) -> Dict[str, torch.Tensor]:
    """The loss terms under the program's names."""
    if task == "STD_CL":
        return {"cl_loss": losses.cross_entropy(out["cl_logits"],
                                                batch["label"])}
    s = loss_cfg["seeder"]
    seeds = seeder.seeds(batch["std_cam"].float(),
                         batch["roi"] if s["use_roi"] else None, gumbel, s,
                         s["weighted"])
    fcams = out["fcams"]
    return {
        "self_learning_tcams": loss_cfg["sl_lambda"]
        * losses.seeded_cross_entropy(fcams, seeds, s["ignore"]),
        "con_ran_field_tcams": loss_cfg["crf_lambda"] * losses.crf(
            fcams, batch["raw"], loss_cfg["crf_sigma_rgb"],
            loss_cfg["crf_sigma_xy"]),
        "max_size_positive_tcams": loss_cfg["size_lambda"]
        * losses.max_size_positive(fcams, elb_t),
    }


def run_steps(model: torch.nn.Module, task: str, batches: List[dict],
              gumbels: List[Optional[torch.Tensor]], loss_cfg: dict,
              opt: dict, precision: str = "fp32", rows: Optional[int] = None,
              loss_rows: Optional[int] = None) -> dict:
    """Trains `model` in place over `batches` (each: raw, label and, for
    TCAM, std_cam and roi).  Planted faults: rows, the first `rows` rows
    of each batch only; loss_rows, the forward over every row and the
    loss terms over the first `loss_rows`.  Returns per step the terms,
    the first step's raw gradients and momentum, and the parameters after
    the last step."""
    sgd = SGD(model, opt)
    out: dict = {"terms": [], "grad": {}, "first_momentum": {}}
    for i, (batch, gumbel) in enumerate(zip(batches, gumbels)):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
            gumbel = None if gumbel is None else gumbel[:rows]
        model.zero_grad(set_to_none=True)
        fwd = model(normalize(batch["raw"]), precision)
        if loss_rows is not None:
            fwd = {k: v[:loss_rows] for k, v in fwd.items()}
            batch = {k: v[:loss_rows] for k, v in batch.items()}
            gumbel = None if gumbel is None else gumbel[:loss_rows]
        t = terms(task, fwd, batch, gumbel, loss_cfg, opt["elb_t"])
        sum(t.values()).backward()
        out["terms"].append({k: float(v.detach()) for k, v in t.items()})
        if i == 0:
            out["grad"] = {n: (p.grad.detach().clone() if p.grad is not None
                               else torch.zeros_like(p))
                           for n, p in model.named_parameters()}
        sgd.step()
        if i == 0:
            out["first_momentum"] = {n: m.clone()
                                     for n, m in sgd.momentum.items()}
    out["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return out
