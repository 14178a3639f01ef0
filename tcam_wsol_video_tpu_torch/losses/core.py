"""Loss framework (port of losses/core.py): elementary losses with an
inclusive epoch window, and the master container summing them."""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclass
class LossInputs:
    """What the ported losses read (the JAX bundle's other fields belong
    to losses not ported yet); NHWC layout."""
    epoch: int = 0
    fcams: Optional[Tensor] = None           # (B, H, W, 2) decoder logits
    raw_img: Optional[Tensor] = None         # (B, H, W, 3) raw [0, 255]
    seeds: Optional[Tensor] = None           # (B, H, W) int {1, 0, ignore}


def softmax_fcams(fcams: Tensor) -> Tensor:
    """Softmax over the decoder's 2 channels."""
    return torch.softmax(fcams, dim=-1)


class ElementaryLoss:
    """Base: subclasses implement compute(inputs, t) -> scalar."""

    def __init__(self, lambda_: float = 1.0, start_ep: int = 0,
                 end_ep: int = -1, seg_ignore_idx: int = -255):
        self.lambda_ = float(lambda_)
        self.start_ep = int(start_ep)
        self.end_ep = None if end_ep == -1 else int(end_ep)
        self.seg_ignore_idx = seg_ignore_idx

    def is_on(self, epoch: int) -> bool:
        # the window includes end_ep; -1 means never stop
        if epoch < self.start_ep:
            return False
        return self.end_ep is None or epoch <= self.end_ep

    @property
    def __name__(self) -> str:
        return re.sub(r"(?<!^)(?=[A-Z])", "_",
                      self.__class__.__name__).lower()

    def compute(self, inputs: LossInputs, t: float) -> Tensor:
        raise NotImplementedError


class MasterLoss:
    """Sum of elementary losses: total = sum_i switch_i * loss_i."""

    def __init__(self, losses: Optional[List[ElementaryLoss]] = None):
        self.losses: List[ElementaryLoss] = list(losses or [])

    def add(self, loss: ElementaryLoss) -> None:
        self.losses.append(loss)

    def switches(self, epoch: int) -> List[float]:
        return [1.0 if l.is_on(epoch) else 0.0 for l in self.losses]

    def compute(self, inputs: LossInputs, t: float,
                switches: Optional[List[float]] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        if not self.losses:
            raise ValueError("MasterLoss empty: add losses before calling")
        if switches is None:
            switches = self.switches(inputs.epoch)
        total = 0.0
        holder: Dict[str, Tensor] = {}
        for loss, on in zip(self.losses, switches):
            v = loss.compute(inputs, t) * float(on)
            holder[loss.__name__] = v
            total = total + v
        return total, holder
