"""Classification heads (port of models/poolings.py): the WGAP head of the
recipe, and the dispatch over head names."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.models.resnet import Linear


class WGAP(nn.Module):
    """Global average pool then linear — the original CAM head, in the
    dtype of its input.  Returns (logits, None): WGAP builds no CAM
    itself."""

    def __init__(self, in_channels: int, classes: int):
        super().__init__()
        self.fc = Linear(in_channels, classes)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.fc(x.mean(dim=(2, 3))), None


def build_pooling_head(name: str, in_channels: int, classes: int
                       ) -> nn.Module:
    """The head called `name` over `in_channels` features.  Only WGAP is
    ported; the other heads of the JAX package raise."""
    if name == constants.WGAP:
        return WGAP(in_channels, classes)
    if name in constants.SPATIAL_POOLINGS:
        raise NotImplementedError(f"pooling head {name} is not ported yet")
    raise ValueError(f"unknown pooling head {name!r}")
