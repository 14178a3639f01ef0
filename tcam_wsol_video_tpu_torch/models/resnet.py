"""WSOL ResNet encoder (port of models/resnet.py), NCHW inside.

A torchvision-style ResNet with layer3 and layer4 at stride 1 (output
stride 8, 28x28 maps at 224 px) returning all six stage features.
Submodule names follow the flax tree (`conv1`, `bn1`, `layer1_0`, ...,
`downsample_conv`, `downsample_bn`) so models/transplant.py maps the JAX
parameters by name.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics update.

    flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) folds the *biased*
    batch variance into `var`; torch's BatchNorm2d folds the unbiased one
    (n / (n - 1) larger, visible at small batches).  Normalization is the
    same; only the running-variance update differs.  Training mode lets
    torch's single pass (cuDNN on the card) update the buffers and then
    takes the Bessel factor back out of the running variance:
        torch: r = (1 - m) r0 + m v n / (n - 1)
        flax:  r = (1 - m) r0 + m v  =  torch's r (1 - 1/n) + (1 - m) r0 / n
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # torch updates (and autograd saves) the copy, which stays intact
        n = x.numel() // x.shape[1]
        var_t = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var_t, self.weight,
                           self.bias, training=True, momentum=self.momentum,
                           eps=self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                var_t, alpha=1.0 - 1.0 / n)
            self.num_batches_tracked.add_(1)
        return out


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """flax nn.Conv with symmetric `padding=k // 2`."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + identity."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = conv(cin, planes * 4, 1, stride)
            self.downsample_bn = BatchNorm2d(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNetWSOL(nn.Module):
    """ResNet-50/101/152 with the WSOL stride pattern.

    forward(x NCHW) returns [x, stem, layer1, layer2, layer3, layer4].
    """
    out_channels = (3, 64, 256, 512, 1024, 2048)

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        # WSOL strides: no downsampling in layer3 and layer4
        plan = [(64, 1, "layer1"), (128, 2, "layer2"), (256, 1, "layer3"),
                (512, 1, "layer4")]
        self.stages: List[List[str]] = []
        cin = 64
        for (planes, stride, lname), nblocks in zip(plan, layers):
            names = []
            for i in range(nblocks):
                first = i == 0
                self.add_module(f"{lname}_{i}", Bottleneck(
                    cin, planes, stride if first else 1, downsample=first))
                cin = planes * 4
                names.append(f"{lname}_{i}")
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = F.relu(self.bn1(self.conv1(x)))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats


def resnet50_wsol() -> ResNetWSOL:
    return ResNetWSOL(layers=(3, 4, 6, 3))
