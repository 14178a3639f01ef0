"""WSOL InceptionV3 encoder (port of models/inception.py), NCHW inside.

The clovaai-WSOL variant: the stem convolutions, InceptionA/B/C mixed
blocks with Mixed_6a at stride 1, and two SPG_A3 blocks (dropout 0.5,
then a biased 3x3 convolution and a ReLU); every 3x3 convolution at
padding 1 and the stem's max pools 3x3/2 in ceil mode.  forward returns
six features, (3 @ 224, 64 @ 112, 80 @ 57, 288 @ 29, 768 @ 29,
1024 @ 29) at 224 px: the input as given, then the stages in the compute
dtype.  BasicConv2d is a bias-free convolution, BatchNorm at eps 1e-3 and
a ReLU.  Submodules carry the flax names (`Conv2d_1a_3x3.conv`,
`Mixed_5b.branch5x5_2.bn`, `SPG_A3_1b.conv`, ...) so models/transplant.py
maps the JAX parameters by name.  The SPG dropout is live in training
mode and draws its masks from the generator given to forward.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tcam_wsol_video_tpu_torch.models.resnet import (BatchNorm2d, Conv2d,
                                                     dropout)

Pad = Union[int, Tuple[int, int]]


def ceil_max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """JAX's max pool 3x3/2 padded (1, 2) with -inf: torch's ceil mode
    gives the same windows (112 -> 57, 56 -> 29; tests hold it over
    sizes)."""
    return F.max_pool2d(x, 3, stride=2, padding=1, ceil_mode=True)


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=padding,
                           bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    """Mixed_6a, at stride 1 in the WSOL variant."""

    def __init__(self, cin: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride, padding=1)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=self.stride, padding=1)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class SPGBlock(nn.Module):
    """Dropout(0.5) + Conv3x3 (biased) + ReLU."""

    def __init__(self, cin: int, cout: int, p: float = 0.5):
        super().__init__()
        self.p = p
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training:
            x = dropout(x, self.p, generator)
        return F.relu(self.conv(x))


class InceptionV3WSOL(nn.Module):
    out_channels = (3, 64, 80, 288, 768, 1024)

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2, padding=1)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, padding=1)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, padding=1)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288, stride=1)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.SPG_A3_1b = SPGBlock(768, 1024)
        self.SPG_A3_2b = SPGBlock(1024, 1024)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        feats = [x]
        y = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(
            x.to(dtype))))
        feats.append(y)
        y = self.Conv2d_3b_1x1(ceil_max_pool_3x3_s2(y))
        feats.append(y)
        y = ceil_max_pool_3x3_s2(self.Conv2d_4a_3x3(y))
        y = self.Mixed_5c(self.Mixed_5b(y))
        feats.append(y)
        for name in ("Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            y = getattr(self, name)(y)
        feats.append(y)
        y = self.SPG_A3_2b(self.SPG_A3_1b(y, generator), generator)
        feats.append(y)
        return feats


def inceptionv3_wsol() -> InceptionV3WSOL:
    return InceptionV3WSOL()
