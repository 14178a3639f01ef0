"""Classification head (port of models/poolings.py): the WGAP head of the
recipe."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class WGAP(nn.Module):
    """Global average pool then linear — the original CAM head.  Returns
    (logits, None): WGAP builds no CAM itself."""

    def __init__(self, in_channels: int, classes: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, classes)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.fc(x.mean(dim=(2, 3))), None
