"""The weights of a cell, made on its device from --seed in one draw.

Every convolution and dense kernel is N(0, 1 / fan_in) (the variance of
flax's lecun_normal, which the program's own initializer follows), every
bias 0, every BatchNorm scale 1, shift 0, running mean 0 and variance 1.
The names and shapes are the reference model's, which are the program's
state-dict keys; the same tensors load into both."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import model as ref_model
from benchmark.reference.keychain import seed_of


def make(task: str, classes: int, seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = ref_model.build(task, classes)
    entries = list(skeleton.state_dict().items())
    kernels = [(k, v) for k, v in entries
               if k.endswith(".weight") and v.dim() >= 2]
    total = sum(v.numel() for _, v in kernels)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "bench", "weights"))
    draw = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, v in kernels:
        n = v.numel()
        fan_in = v[0].numel()
        out[k] = draw[off:off + n].view(v.shape) * fan_in ** -0.5
        off += n
    for k, v in entries:
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(("running_var", ".weight")):
            out[k] = torch.ones(v.shape, device=device)
        else:  # biases, BatchNorm shifts and running means
            out[k] = torch.zeros(v.shape, device=device)
    return out
