"""TCAM losses of the stage-2 recipe (port of losses/tcam.py):
self-learning CE on the seeds, the spatial dense CRF, and the
max-size-positive ELB."""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.losses.core import (ElementaryLoss,
                                                   LossInputs, softmax_fcams)
from tcam_wsol_video_tpu_torch.losses.elb import elb
from tcam_wsol_video_tpu_torch.losses.fcam import cross_entropy_ignore
from tcam_wsol_video_tpu_torch.ops.crf import dense_crf_loss


class SelfLearningTcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        return self.lambda_ * cross_entropy_ignore(
            inputs.fcams, inputs.seeds, self.seg_ignore_idx)


class ConRanFieldTcams(ElementaryLoss):
    def __init__(self, sigma_rgb=15.0, sigma_xy=100.0, scale_factor=1.0,
                 impl="exact", **kw):
        super().__init__(**kw)
        self.sigma_rgb = sigma_rgb
        self.sigma_xy = sigma_xy
        self.scale_factor = scale_factor
        self.impl = impl

    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        return self.lambda_ * dense_crf_loss(
            inputs.raw_img, probs, self.sigma_rgb, self.sigma_xy,
            self.scale_factor, method=self.impl)


class MaxSizePositiveTcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        b = probs.shape[0]
        loss = 0.0
        for c in (0, 1):
            area = probs[..., c].reshape(b, -1).sum(-1)
            loss = loss + elb(-area, t)
        return self.lambda_ * loss * 0.5
