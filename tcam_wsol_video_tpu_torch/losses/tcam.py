"""TCAM losses (port of losses/tcam.py): self-learning CE on the seeds,
the spatial dense CRF, the temporal joint (color-only) CRF over a clip,
pixel entropy, and the ELB size priors (max-size-positive, background
>= foreground, foreground size around its temporal estimate, nothing
outside the box)."""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.losses import fcam
from tcam_wsol_video_tpu_torch.losses.core import (ElementaryLoss,
                                                   LossInputs, softmax_fcams)
from tcam_wsol_video_tpu_torch.losses.elb import elb
from tcam_wsol_video_tpu_torch.ops.crf import color_dense_crf_loss


def _areas(probs: torch.Tensor, c: int) -> torch.Tensor:
    """(B,) summed probability of channel c."""
    return probs[..., c].reshape(probs.shape[0], -1).sum(-1)


# the terms TCAM shares with F-CAM: the same computation under the
# TCAM names (the loss names come from the class names)
class SelfLearningTcams(fcam.SelfLearningFcams):
    pass


class ConRanFieldTcams(fcam.ConRanFieldFcams):
    pass


class RgbJointConRanFieldTcams(ElementaryLoss):
    """Temporal joint CRF: batch rows are clip-major, clip_len frames per
    clip in frame order; each clip's frames are concatenated along width
    and go through the color-only CRF (which divides by the clip count,
    the reference's mean over clips)."""

    def __init__(self, clip_len: int, sigma_rgb=15.0, scale_factor=1.0,
                 impl="exact", n_landmarks=1024, rff_freqs=2048, **kw):
        super().__init__(**kw)
        if clip_len < 1:
            raise ValueError(f"clip_len must be >= 1, got {clip_len}")
        self.clip_len = clip_len
        self.sigma_rgb = sigma_rgb
        self.scale_factor = scale_factor
        self.impl = impl
        self.n_landmarks = n_landmarks
        self.rff_freqs = rff_freqs

    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        if self.clip_len < 2:
            return torch.zeros((), device=inputs.fcams.device)
        probs = softmax_fcams(inputs.fcams)
        b, h, w, k = probs.shape
        n_clips = b // self.clip_len
        if n_clips * self.clip_len != b:
            raise ValueError(f"batch {b} is not whole clips of "
                             f"{self.clip_len}")

        def side_by_side(x, c):
            # (n_clips, T, H, W, C) -> (n_clips, H, T * W, C)
            x = x.reshape(n_clips, self.clip_len, h, w, c)
            return x.permute(0, 2, 1, 3, 4).reshape(
                n_clips, h, self.clip_len * w, c)

        return self.lambda_ * color_dense_crf_loss(
            side_by_side(inputs.raw_img, 3), side_by_side(probs, k),
            self.sigma_rgb, self.scale_factor, method=self.impl,
            n_landmarks=self.n_landmarks, rff_freqs=self.rff_freqs)


class EntropyTcams(fcam.EntropyFcams):
    pass


class MaxSizePositiveTcams(fcam.MaxSizePositiveFcams):
    pass


class BgSizeGreatSizeFgTcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        return self.lambda_ * elb(-(_areas(probs, 0) - _areas(probs, 1)), t)


class FgSizeTcams(ElementaryLoss):
    def __init__(self, eps: float = 0.001, **kw):
        super().__init__(**kw)
        if eps < 0:
            raise ValueError(f"eps must be >= 0, got {eps}")
        self.eps = float(eps)

    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        _, h, w, _ = probs.shape
        fg = _areas(probs, 1) / float(h * w)
        loss = elb(inputs.fg_size - self.eps - fg, t)
        loss = loss + elb(fg - inputs.fg_size - self.eps, t)
        return self.lambda_ * loss / 2.0


class EmptyOutsideBboxTcams(ElementaryLoss):
    def compute(self, inputs: LossInputs, t) -> torch.Tensor:
        probs = softmax_fcams(inputs.fcams)
        out = probs[..., 1] * (1.0 - inputs.msk_bbox)
        return self.lambda_ * elb(out.reshape(out.shape[0], -1).sum(-1), t)
