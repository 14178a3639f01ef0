"""Classification heads (port of models/poolings.py), NCHW inside.

Each head maps the last feature (B, C, h, w) to (logits, maps) in the
feature's dtype.  WGAP (average pool, then the fc layer: the CAM paper's
head) builds no maps and returns None for them.  GAP, MaxPool,
LogSumExpPool and WildCatCLHead build per-class maps (B, K, h, w) with a
1x1 convolution and pool them into logits; the maps come back detached.
With support_background a head builds one more map and logit for the
background class at index 0: the logits drop it, the maps keep it.  WGAP
takes support_background and ignores it, as JAX's does.

WildCat (CVPR'17): modalities maps per class averaged into one, the
activations sorted in descending order, dropout on the sorted values in
training (each kept with probability 1 - p and scaled by 1 / (1 - p),
drawn from the generator given to forward, never from the global
stream), then the mean of the kmax largest.  The reference's kmin term
is a no-op (a non-inplace add whose result it drops), so the decision is
the kmax mean alone, as in JAX; kmin and alpha are taken and unused.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.models.resnet import (Conv2d, Linear,
                                                     dropout as drop)

HeadOut = Tuple[torch.Tensor, Optional[torch.Tensor]]


class WGAP(nn.Module):
    """Global average pool then linear; builds no maps."""
    builtin_cam = False

    def __init__(self, in_channels: int, classes: int,
                 support_background: bool = False):
        super().__init__()
        self.fc = Linear(in_channels, classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> HeadOut:
        return self.fc(x.mean(dim=(2, 3))), None


class _MapHead(nn.Module):
    """A 1x1 convolution (flax name `conv`) to one map per class, plus
    the background's with support_background; `pool` turns the maps into
    logits."""
    builtin_cam = True

    def __init__(self, in_channels: int, classes: int,
                 support_background: bool = False):
        super().__init__()
        self.support_background = support_background
        self.conv = Conv2d(in_channels, classes + int(support_background),
                           1, bias=True)

    def pool(self, maps: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> HeadOut:
        maps = self.conv(x)
        logits = self.pool(maps)
        if self.support_background:
            logits = logits[:, 1:]
        return logits, maps.detach()


class GAP(_MapHead):
    """1x1 convolution to class maps, then global average pooling."""

    def pool(self, maps: torch.Tensor) -> torch.Tensor:
        return maps.mean(dim=(2, 3))


class MaxPool(_MapHead):
    def pool(self, maps: torch.Tensor) -> torch.Tensor:
        return maps.amax(dim=(2, 3))


class LogSumExpPool(_MapHead):
    """log(mean(exp(r (a - max)))) / r + max over each map."""

    def __init__(self, in_channels: int, classes: int,
                 support_background: bool = False, r: float = 10.0):
        super().__init__(in_channels, classes, support_background)
        self.r = r

    def pool(self, maps: torch.Tensor) -> torch.Tensor:
        m = maps.amax(dim=(2, 3), keepdim=True)
        return (torch.log(torch.exp(self.r * (maps - m)).mean(dim=(2, 3)))
                / self.r + m[:, :, 0, 0])


def _wildcat_k(k, n: int) -> int:
    """The reference's get_k: the count of activations that k selects out
    of n.  An int 1 is one activation; a float 1.0 is all n."""
    if k <= 0:
        return 0
    if k < 1:
        return round(k * n)
    if k == 1 and isinstance(k, float):
        return int(n)
    if k == 1 and isinstance(k, int):
        return 1
    return int(min(k, n))


class WildCatCLHead(nn.Module):
    builtin_cam = True

    def __init__(self, in_channels: int, classes: int,
                 support_background: bool = False, modalities: int = 5,
                 kmax: float = 0.5, kmin: Optional[float] = None,
                 alpha: float = 0.6, dropout: float = 0.0):
        super().__init__()
        self.support_background = support_background
        self.modalities = modalities
        self.kmax = kmax
        self.p = dropout
        self.classes = classes + int(support_background)
        self.to_modalities = Conv2d(in_channels, self.classes * modalities,
                                    1, bias=True)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> HeadOut:
        mod = self.to_modalities(x)
        b, _, h, w = mod.shape
        maps = mod.view(b, self.classes, self.modalities, h, w).mean(dim=2)
        n = h * w
        srt = maps.reshape(b, self.classes, n).sort(dim=-1,
                                                    descending=True).values
        if self.training and self.p > 0.0:
            srt = drop(srt, self.p, generator)
        kmax = _wildcat_k(self.kmax, n)
        if kmax == 0:
            raise ValueError("WildCat needs kmax > 0")
        scores = srt[..., :kmax].sum(dim=-1) / kmax
        if self.support_background:
            scores = scores[:, 1:]
        return scores, maps.detach()


def build_pooling_head(name: str, in_channels: int, classes: int,
                       support_background: bool = False, r: float = 10.0,
                       modalities: int = 5, kmax: float = 0.5,
                       kmin: Optional[float] = None, alpha: float = 0.6,
                       dropout: float = 0.0) -> nn.Module:
    """The head called `name` over `in_channels` features, with JAX's
    keyword arguments (r: LogSumExpPool; the rest: WildCat)."""
    if name == constants.WGAP:
        return WGAP(in_channels, classes, support_background)
    if name == constants.GAP:
        return GAP(in_channels, classes, support_background)
    if name == constants.MAX_POOL:
        return MaxPool(in_channels, classes, support_background)
    if name == constants.LSE_POOL:
        return LogSumExpPool(in_channels, classes, support_background, r=r)
    if name == constants.WILDCAT:
        return WildCatCLHead(in_channels, classes, support_background,
                             modalities=modalities, kmax=kmax, kmin=kmin,
                             alpha=alpha, dropout=dropout)
    raise ValueError(f"unknown pooling head {name!r}")


def head_kwargs(args) -> dict:
    """build_pooling_head's keyword arguments from a config."""
    return dict(support_background=args.support_background, r=args.lse_r,
                modalities=args.wc_modalities, kmax=args.wc_kmax,
                kmin=args.wc_kmin, alpha=args.wc_alpha,
                dropout=args.wc_dropout)
