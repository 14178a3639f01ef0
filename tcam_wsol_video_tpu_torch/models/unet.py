"""UnetTCAM (port of models/unet.py), NCHW inside.

Encoder + classification head on the last feature + U-Net decoder
(nearest x2 upsample, align_corners bilinear snap to the skip resolution
on mismatch, concat, two Conv3x3+BN+ReLU) + 2-channel segmentation head
upsampled to the input size.  forward takes NHWC images and returns
cl_logits (B, K), fcams (B, H, W, 2) and the encoder features (NCHW).

freeze_cl: the encoder and head run without autograd and keep their BN
in inference mode (the JAX model's stop_gradient + enc_train=False); the
decoder BN still trains.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.models.poolings import WGAP
from tcam_wsol_video_tpu_torch.models.resnet import BatchNorm2d, conv
from tcam_wsol_video_tpu_torch.ops.interpolate import (
    resize_bilinear, resize_nearest, resize_nearest_then_bilinear)


class Conv2dReLU(nn.Module):
    """Conv 3x3 + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv(cin, cout, 3)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + cskip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor]) -> torch.Tensor:
        h, w = x.shape[-2:]
        if skip is not None and (2 * h, 2 * w) != tuple(skip.shape[-2:]):
            x = resize_nearest_then_bilinear(
                x, (2 * h, 2 * w), skip.shape[-2:], align_corners=True,
                layout="nchw")
        else:
            x = resize_nearest(x, (2 * h, 2 * w), layout="nchw")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    """Classic U-Net decoder over the staged encoder features."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        # drop the input-resolution feature, reverse to start at the head
        enc = list(encoder_channels[1:])[::-1]
        head, skips = enc[0], enc[1:]
        cin = head
        self.blocks = len(decoder_channels)
        for i, ch in enumerate(decoder_channels):
            cskip = skips[i] if i < len(skips) else 0
            self.add_module(f"block_{i}", DecoderBlock(cin, cskip, ch))
            cin = ch

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        x, skips = feats[0], feats[1:]
        for i in range(self.blocks):
            skip = skips[i] if i < len(skips) else None
            x = getattr(self, f"block_{i}")(x, skip)
        return x


class SegmentationHead(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.conv = conv(cin, cout, kernel_size, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetTCAM(nn.Module):
    def __init__(self, encoder: nn.Module, pooling: str, classes: int,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 seg_h_out_channels: int = 2, freeze_cl: bool = False):
        super().__init__()
        if pooling != constants.WGAP:
            raise NotImplementedError(f"pooling head {pooling} is not "
                                      "ported yet")
        self.freeze_cl = freeze_cl
        self.encoder = encoder
        self.classification_head = WGAP(encoder.out_channels[-1], classes)
        self.decoder = UnetDecoder(encoder.out_channels, decoder_channels)
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  seg_h_out_channels)

    def train(self, mode: bool = True) -> "UnetTCAM":
        super().train(mode)
        if self.freeze_cl:
            # a frozen classifier keeps its BN running statistics
            self.encoder.eval()
            self.classification_head.eval()
        return self

    def forward(self, x: torch.Tensor) -> dict:
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_cl):
            features: List[torch.Tensor] = self.encoder(x_nchw)
            cl_logits, _ = self.classification_head(features[-1])
        fcams = self.segmentation_head(self.decoder(features))
        if tuple(fcams.shape[-2:]) != tuple(x.shape[1:3]):
            fcams = resize_bilinear(fcams, x.shape[1:3], align_corners=True,
                                    layout="nchw")
        return {"cl_logits": cl_logits, "fcams": fcams.permute(0, 2, 3, 1),
                "features": features}
