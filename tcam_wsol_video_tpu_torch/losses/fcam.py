"""F_CL (F-CAM) losses (port of losses/fcam.py): the self-learning CE on
the seeds with an ignore index, the spatial dense CRF, the pixel entropy
(log2) of the softmax maps, the ELB size prior on both channels, and the
image reconstruction (also a TCAM loss under im_rec).

ImgReconstruction compares the model input x_in (the normalized image)
with the reconstruction in [0, img_range], as the JAX package does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tcam_wsol_video_tpu_torch.losses.core import (ElementaryLoss,
                                                   LossInputs, softmax_fcams)
from tcam_wsol_video_tpu_torch.losses.elb import elb
from tcam_wsol_video_tpu_torch.ops.crf import dense_crf_loss


def cross_entropy_ignore_sum_count(fcams_logits: torch.Tensor,
                                   seeds: torch.Tensor, ignore_idx: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the per-pixel NLL over the seeded pixels, their count).
    fcams_logits (B, H, W, K); seeds (B, H, W) int in {0..K-1,
    ignore_idx}."""
    valid = seeds != ignore_idx
    tgt = torch.where(valid, seeds, 0).long()
    logp = torch.log_softmax(fcams_logits.float(), dim=-1)
    oh = F.one_hot(tgt, logp.shape[-1]).to(logp.dtype)
    nll = -(logp * oh).sum(-1)
    return (torch.where(valid, nll, 0.0).sum(),
            valid.sum().to(torch.float32))


def cross_entropy_ignore(fcams_logits: torch.Tensor, seeds: torch.Tensor,
                         ignore_idx: int) -> torch.Tensor:
    """Mean CE over the seeded pixels (1 for an empty seed map's 0)."""
    s, n = cross_entropy_ignore_sum_count(fcams_logits, seeds, ignore_idx)
    return s / n.clamp_min(1)


class SelfLearningFcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        return self.lambda_ * cross_entropy_ignore(
            inputs.fcams, inputs.seeds, self.seg_ignore_idx)

    def compute_numden(self, inputs: LossInputs, t):
        """(numerator, denominator) whose sums over equal chunks of the
        batch give the loss: the CE's data-dependent count."""
        s, n = cross_entropy_ignore_sum_count(inputs.fcams, inputs.seeds,
                                              self.seg_ignore_idx)
        return self.lambda_ * s, n


class ConRanFieldFcams(ElementaryLoss):
    def __init__(self, sigma_rgb=15.0, sigma_xy=100.0, scale_factor=1.0,
                 impl="exact", n_landmarks=1024, rff_freqs=2048, **kw):
        super().__init__(**kw)
        self.sigma_rgb = sigma_rgb
        self.sigma_xy = sigma_xy
        self.scale_factor = scale_factor
        self.impl = impl
        self.n_landmarks = n_landmarks
        self.rff_freqs = rff_freqs

    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        return self.lambda_ * dense_crf_loss(
            inputs.raw_img, probs, self.sigma_rgb, self.sigma_xy,
            self.scale_factor, method=self.impl,
            n_landmarks=self.n_landmarks, rff_freqs=self.rff_freqs)


class EntropyFcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        ent = -(probs * torch.log2(probs.clamp_min(1e-12))).sum(-1)
        return self.lambda_ * ent.mean()


class MaxSizePositiveFcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        b = probs.shape[0]
        loss = 0.0
        for c in (0, 1):
            loss = loss + elb(-probs[..., c].reshape(b, -1).sum(-1), t)
        return self.lambda_ * loss * 0.5


class ImgReconstruction(ElementaryLoss):
    """The per-sample MSE between x_in and im_recon: averaged, or through
    the ELB with use_elb (im_rec_elb)."""

    def __init__(self, use_elb: bool = False, **kw):
        super().__init__(**kw)
        self.use_elb = use_elb

    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        n = inputs.x_in.shape[0]
        mse = ((inputs.x_in - inputs.im_recon) ** 2).reshape(n, -1).mean(1)
        if self.use_elb:
            return self.lambda_ * elb(mse, t)
        return self.lambda_ * mse.mean()
