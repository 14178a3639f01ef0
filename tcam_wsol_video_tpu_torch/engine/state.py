"""Train state (port of engine/state.py): the model (parameters and BN
statistics), its optimizer, the ELB temperature, the step and epoch."""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    elb_t: float = 1.0
    step: int = 0
    epoch: int = 0
