"""STD_CL classification loss (port of losses/std.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tcam_wsol_video_tpu_torch.losses.core import ElementaryLoss, LossInputs


class ClLoss(ElementaryLoss):
    """Mean softmax cross-entropy of the logits, in float32."""

    def compute(self, inputs: LossInputs, t: float) -> torch.Tensor:
        ce = F.cross_entropy(inputs.cl_logits.float(), inputs.glabel.long())
        return self.lambda_ * ce
