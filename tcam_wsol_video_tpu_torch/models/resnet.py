"""WSOL ResNet encoder (port of models/resnet.py), NCHW inside.

A torchvision-style ResNet with layer3 and layer4 at stride 1 (output
stride 8, 28x28 maps at 224 px) returning all six stage features.
Submodule names follow the flax tree (`conv1`, `bn1`, `layer1_0`, ...,
`downsample_conv`, `downsample_bn`) so models/transplant.py maps the JAX
parameters by name.

Compute dtype, as flax's `dtype=` on every layer: the parameters stay
fp32; a convolution or dense layer casts its kernel and bias to its
input's dtype and returns that dtype; BatchNorm reduces its statistics
and normalizes in fp32 and returns its input's dtype.  So the dtype of
the image given to `forward` (cast there) runs through every layer.

Random weights follow flax's defaults: convolution and dense kernels
lecun_normal, biases zero, BatchNorm scale 1 and bias 0.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


# the std of a unit normal truncated at +-2 (jax.nn.initializers.
# variance_scaling's correction for its truncated_normal)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default kernel initializer: a normal truncated at two of its
    standard deviations, with variance 1 / fan_in after the truncation.
    (torch's default, uniform with variance 1 / (3 fan_in), would start a
    random-weight run at 1/sqrt(3) of the JAX package's weight scale.)"""
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (fp32 parameters), with
    flax's initialization."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (fp32 parameters), with
    flax's initialization."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


_FROZEN_STATISTICS = [False]


@contextlib.contextmanager
def frozen_statistics():
    """Within: BatchNorm2d in training mode normalizes with the batch's
    statistics as always but leaves its running buffers and counter as
    they are (a recomputed forward, engine/steps.py remat, must not fold
    the batch in a second time)."""
    prev = _FROZEN_STATISTICS[0]
    _FROZEN_STATISTICS[0] = True
    try:
        yield
    finally:
        _FROZEN_STATISTICS[0] = prev


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics update.

    The statistics, the running buffers and the normalization are fp32
    whatever the input's dtype (torch's mixed-dtype batch norm, as flax's
    force_float32_reductions); the output is rounded once to the input's
    dtype.

    flax.linen.BatchNorm(momentum=0.9, epsilon=eps) folds the *biased*
    batch variance into `var`; torch's BatchNorm2d folds the unbiased one
    (n / (n - 1) larger, visible at small batches).  Normalization is the
    same; only the running-variance update differs.  Training mode lets
    torch's single pass (cuDNN on the card) update the buffers and then
    takes the Bessel factor back out of the running variance:
        torch: r = (1 - m) r0 + m v n / (n - 1)
        flax:  r = (1 - m) r0 + m v  =  torch's r (1 - 1/n) + (1 - m) r0 / n
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # torch updates (and autograd saves) the copy, which stays intact
        n = x.numel() // x.shape[1]
        var_t = self.running_var.clone()
        if _FROZEN_STATISTICS[0]:
            return F.batch_norm(x, self.running_mean.clone(), var_t,
                                self.weight, self.bias, training=True,
                                momentum=self.momentum, eps=self.eps)
        out = F.batch_norm(x, self.running_mean, var_t, self.weight,
                           self.bias, training=True, momentum=self.momentum,
                           eps=self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                var_t, alpha=1.0 - 1.0 / n)
            self.num_batches_tracked.add_(1)
        return out


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = False) -> Conv2d:
    """flax nn.Conv with symmetric `padding=k // 2`."""
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


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

    forward(x NCHW, dtype) returns [x, stem, layer1, layer2, layer3,
    layer4]: x as given, the stages computed in `dtype`.  `generator` is
    taken for the encoders' common signature (this one draws nothing).
    """
    out_channels = (3, 64, 256, 512, 1024, 2048)

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = conv(3, 64, 7, stride=2)
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

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        feats = [x]
        y = F.relu(self.bn1(self.conv1(x.to(dtype))))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats


def resnet50_wsol() -> ResNetWSOL:
    return ResNetWSOL(layers=(3, 4, 6, 3))


def resnet101_wsol() -> ResNetWSOL:
    return ResNetWSOL(layers=(3, 4, 23, 3))


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout in training: each entry kept with probability 1 - p
    and scaled by 1 / (1 - p), in x's dtype.  The mask is drawn from
    `generator` (on x's device), never from the global stream; a missing
    generator raises."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
