"""UnetFCAM and its alias UnetTCAM (port of models/unet.py), NCHW inside.

Encoder + classification head (any pooling head, with or without the
background class) on the last feature + U-Net decoder (on VGG a center
block of two Conv3x3+BN+ReLU first; then nearest x2 upsample,
align_corners bilinear snap to the skip resolution on mismatch, concat,
two Conv3x3+BN+ReLU) + 2-channel segmentation head upsampled to the
input size; with im_rec, a reconstruction head on the decoder's output
(3x3 conv, then (tanh + 1) / 2 img_range).  forward takes NHWC images,
the compute dtype (models/resnet.py) and the generator of the encoder's
and head's dropout (InceptionV3, WildCat) in training, and returns
cl_logits (B, K), fcams (B, H, W, 2), im_recon (B, h, w, 3) at the
decoder's resolution (None without im_rec), the head's maps cams_head
and the encoder features (NCHW), all in that dtype: the decoder, the
heads and the final upsample follow their inputs' dtype.  F_CL and TCAM
share the model, as in JAX.

freeze_cl: the encoder and head run without autograd and keep their BN
in inference mode (the JAX model's stop_gradient + enc_train=False); the
decoder BN still trains.

The decoder and the heads keep their activations channels-last (NCHW
shape, NHWC memory), as the encoder's already are: cuDNN then runs its
NHWC convolutions with no layout transposes, BatchNorm takes torch's
channels-last kernels, and fcams and im_recon come out as contiguous
NHWC tensors.  The resizes are the separable products of
ops/interpolate's matrices, taken on the NHWC memory by `_resize_cl`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tcam_wsol_video_tpu_torch.models.poolings import build_pooling_head
from tcam_wsol_video_tpu_torch.models.resnet import BatchNorm2d, conv
from tcam_wsol_video_tpu_torch.ops.interpolate import (
    _linear_matrix, _nearest_matrix, _on, _snap_matrix)

_CL = torch.channels_last


def _resize_cl(x: torch.Tensor, build, args_h: tuple, args_w: tuple
               ) -> torch.Tensor:
    """mh @ x @ mw^T over the spatial axes of the NCHW-shaped x, with
    mh = build(*args_h) (p, h) and mw = build(*args_w) (q, w): the
    products of ops/interpolate's separable resize in its order (rows,
    then columns), taken as two matmuls on the NHWC memory so that the
    result is channels-last with no copy."""
    n, c, h, w = x.shape
    mh = _on(x.device, x.dtype, build, *args_h)
    mw = _on(x.device, x.dtype, build, *args_w)
    p, q = mh.shape[0], mw.shape[0]
    y = torch.matmul(mh, x.permute(0, 2, 3, 1).reshape(n, h, w * c))
    y = torch.matmul(mw, y.view(n * p, w, c))
    return y.view(n, p, q, c).permute(0, 3, 1, 2)


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
            sh, sw = skip.shape[-2:]
            x = _resize_cl(x, _snap_matrix, (h, 2 * h, sh, True),
                           (w, 2 * w, sw, True))
        else:
            x = _resize_cl(x, _nearest_matrix, (h, 2 * h), (w, 2 * w))
        if skip is not None:
            x = torch.cat([x, skip.contiguous(memory_format=_CL)], dim=1)
        return self.conv2(self.conv1(x))


class CenterBlock(nn.Module):
    """Two Conv3x3+BN+ReLU at the head's width (the VGG decoder's)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2dReLU(channels, channels)
        self.conv2 = Conv2dReLU(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    """Classic U-Net decoder over the staged encoder features."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 center: bool = False):
        super().__init__()
        # drop the input-resolution feature, reverse to start at the head
        enc = list(encoder_channels[1:])[::-1]
        head, skips = enc[0], enc[1:]
        self.center = CenterBlock(head) if center else None
        cin = head
        self.blocks = len(decoder_channels)
        for i, ch in enumerate(decoder_channels):
            cskip = skips[i] if i < len(skips) else 0
            self.add_module(f"block_{i}", DecoderBlock(cin, cskip, ch))
            cin = ch

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        x, skips = feats[0].contiguous(memory_format=_CL), feats[1:]
        if self.center is not None:
            x = self.center(x)
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


class ReconstructionHead(nn.Module):
    """3x3 conv to 3 channels, mapped into [0, img_range] by
    (tanh + 1) / 2 img_range."""

    def __init__(self, cin: int, img_range: float = 1.0):
        super().__init__()
        self.conv = conv(cin, 3, 3, bias=True)
        self.img_range = img_range

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.tanh(self.conv(x)) + 1.0) * 0.5 * self.img_range


class UnetFCAM(nn.Module):
    def __init__(self, encoder: nn.Module, pooling: str, classes: int,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 seg_h_out_channels: int = 2, freeze_cl: bool = False,
                 im_rec: bool = False, img_range: float = 1.0,
                 center: bool = False, support_background: bool = False,
                 **head_kw):
        """head_kw: build_pooling_head's hyperparameters (r, modalities,
        kmax, kmin, alpha, dropout)."""
        super().__init__()
        self.freeze_cl = freeze_cl
        self.encoder = encoder
        self.classification_head = build_pooling_head(
            pooling, encoder.out_channels[-1], classes,
            support_background=support_background, **head_kw)
        self.decoder = UnetDecoder(encoder.out_channels, decoder_channels,
                                   center=center)
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  seg_h_out_channels)
        self.reconstruction_head = (
            ReconstructionHead(decoder_channels[-1], img_range) if im_rec
            else None)

    def train(self, mode: bool = True) -> "UnetFCAM":
        super().train(mode)
        if self.freeze_cl:
            # a frozen classifier keeps its BN running statistics
            self.encoder.eval()
            self.classification_head.eval()
        return self

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> dict:
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_cl):
            features: List[torch.Tensor] = self.encoder(x_nchw, dtype,
                                                        generator)
            cl_logits, cams_head = self.classification_head(features[-1],
                                                            generator)
        dec = self.decoder(features)
        fcams = self.segmentation_head(dec)
        (h, w), (hi, wi) = fcams.shape[-2:], x.shape[1:3]
        if (h, w) != (hi, wi):
            fcams = _resize_cl(fcams, _linear_matrix, (h, hi, True),
                               (w, wi, True))
        im_recon = None
        if self.reconstruction_head is not None:
            im_recon = self.reconstruction_head(dec).permute(0, 2, 3, 1)
        return {"cl_logits": cl_logits, "fcams": fcams.permute(0, 2, 3, 1),
                "im_recon": im_recon, "cams_head": cams_head,
                "features": features}


# TCAM's model is F-CAM's (the JAX package keeps the same alias)
UnetTCAM = UnetFCAM
