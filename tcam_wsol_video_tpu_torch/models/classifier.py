"""STDClassifier, the stage-1 model of task STD_CL, and DenseBoxNet, the
model of task C_BOX (port of models/classifier.py), NCHW inside.

Encoder + pooling head on the last feature.  forward takes NHWC images,
the compute dtype (models/resnet.py) and a generator for the dropout of
InceptionV3's SPG blocks and of WildCat in training, and returns
cl_logits (B, K), cams_head (the head's maps (B, K', h, w), detached;
None for WGAP, which builds none) and the encoder features (NCHW), all
in that dtype.  The submodules are named `encoder` and
`classification_head` as in UnetTCAM, so stage 2 loads them from a
stage-1 snapshot, and models/transplant.py maps the flax tree onto them
by name.  `head_from_features` runs the head alone: the gradient CAM
methods differentiate it with respect to the last feature.

DenseBoxNet: encoder, the spatial mean of its last feature, and a
Linear(C, 4) `box_head` giving one raw box (x1, y1, x2, y2) per image
(ops/box_stats turns it into masks).  Under freeze_encoder the encoder
stays in eval mode whatever the model's mode (BN reads its running
statistics and leaves them as they are) and records no gradient, as
JAX's encoder at train=False under stop_gradient.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tcam_wsol_video_tpu_torch.models.poolings import build_pooling_head
from tcam_wsol_video_tpu_torch.models.resnet import Linear


class STDClassifier(nn.Module):
    def __init__(self, encoder: nn.Module, pooling: str, classes: int,
                 support_background: bool = False, **head_kw):
        """head_kw: build_pooling_head's hyperparameters (r, modalities,
        kmax, kmin, alpha, dropout)."""
        super().__init__()
        self.encoder = encoder
        self.classification_head = build_pooling_head(
            pooling, encoder.out_channels[-1], classes,
            support_background=support_background, **head_kw)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> dict:
        features = self.encoder(x.permute(0, 3, 1, 2), dtype, generator)
        cl_logits, cams_head = self.classification_head(features[-1],
                                                        generator)
        return {"cl_logits": cl_logits, "cams_head": cams_head,
                "features": features}

    def head_from_features(self, feat: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The pooling head alone on a (B, C, h, w) feature map."""
        return self.classification_head(feat, generator)


class DenseBoxNet(nn.Module):
    def __init__(self, encoder: nn.Module, freeze_encoder: bool = False):
        super().__init__()
        self.encoder = encoder
        self.freeze_encoder = freeze_encoder
        self.box_head = Linear(encoder.out_channels[-1], 4)

    def train(self, mode: bool = True) -> "DenseBoxNet":
        super().train(mode)
        if self.freeze_encoder:
            self.encoder.train(False)
        return self

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> dict:
        # a frozen encoder's output takes no gradient: none is recorded
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_encoder):
            features = self.encoder(x.permute(0, 3, 1, 2), dtype, generator)
        z = features[-1].mean((2, 3))
        return {"box": self.box_head(z), "features": features}
