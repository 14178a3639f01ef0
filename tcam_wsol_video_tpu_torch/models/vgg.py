"""WSOL VGG16 encoder (port of models/vgg.py), NCHW inside.

The WSOL16 configuration: [64, 64 | M, 128, 128 | M, 256 x 3 | M, 512 x 6]
then conv6 (512 -> 1024), every convolution 3x3 with a bias and a ReLU,
no BatchNorm.  Output stride 8 (28x28 at 224 px).  The stages split at
the max pools, so forward returns four features (64 @ 1, 128 @ 1/2,
256 @ 1/4, 1024 @ 1/8); the U-Net decoder drops the first.  The
convolutions carry the flax names `conv_0` ... `conv_12` and `conv6`, so
models/transplant.py maps the JAX parameters by name.  Compute dtype and
initialization as models/resnet.py.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tcam_wsol_video_tpu_torch.models.resnet import conv

# (channels of each convolution, max pool before the stage)
_WSOL16_STAGES = (
    ((64, 64), False),
    ((128, 128), True),
    ((256, 256, 256), True),
    ((512, 512, 512, 512, 512, 512), True),   # + conv6 below
)


class VGG16WSOL(nn.Module):
    out_channels = (64, 128, 256, 1024)

    def __init__(self):
        super().__init__()
        self.stages: List[tuple] = []
        cin, idx = 3, 0
        for chans, pool in _WSOL16_STAGES:
            names = []
            for c in chans:
                self.add_module(f"conv_{idx}", conv(cin, c, 3, bias=True))
                names.append(f"conv_{idx}")
                cin, idx = c, idx + 1
            self.stages.append((pool, names))
        self.conv6 = conv(cin, 1024, 3, bias=True)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """x NCHW -> the four stage features in `dtype` (`generator` is
        taken for the encoders' common signature; VGG draws nothing)."""
        feats = []
        y = x.to(dtype)
        for pool, names in self.stages:
            if pool:
                y = F.max_pool2d(y, 2, stride=2)
            for name in names:
                y = F.relu(getattr(self, name)(y))
            feats.append(y)
        feats[-1] = F.relu(self.conv6(feats[-1]))
        return feats


def vgg16_wsol() -> VGG16WSOL:
    return VGG16WSOL()
