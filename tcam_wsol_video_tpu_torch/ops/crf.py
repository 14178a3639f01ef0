"""Dense-CRF regularization, exact path (port of ops/crf.py).

AS = W s with W_ij = exp(-1/2 ||f_i - f_j||^2) over the features
f = (x/sigma_xy, y/sigma_xy, rgb/sigma_rgb); the loss is -sum(s * AS) / N
and its gradient treats AS as a constant: d loss / d s = -2 AS / N.  The
filter runs in the CUDA kernel of ops/cuda/bilateral.py on the card and
in its plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
from tcam_wsol_video_tpu_torch.ops.interpolate import (resize_bilinear,
                                                       resize_nearest)


def make_bilateral_features(images: torch.Tensor, sigma_rgb: float,
                            sigma_xy: Optional[float]) -> torch.Tensor:
    """images (B, H, W, C) raw [0, 255] -> (B, H*W, D) features, D = C
    (+2 with sigma_xy, ordered x, y, r, g, b; x is the width coordinate)."""
    b, h, w, c = images.shape
    feats = [images.reshape(b, h * w, c).float() / sigma_rgb]
    if sigma_xy is not None:
        dev = images.device
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
        feats = [(xy / sigma_xy).expand(b, h * w, 2)] + feats
    return torch.cat(feats, dim=-1)


def bilateral_filter_batch(images: torch.Tensor, segs: torch.Tensor,
                           sigma_rgb: float, sigma_xy: Optional[float],
                           method: str = "exact") -> torch.Tensor:
    """images (B, H, W, 3) in [0, 255]; segs (B, H, W, K) -> AS with segs'
    shape.  sigma_xy=None selects the color-only kernel."""
    if method != "exact":
        raise NotImplementedError(f"crf method {method} is not ported yet")
    b, h, w, k = segs.shape
    feats = make_bilateral_features(images, sigma_rgb, sigma_xy)
    vals = segs.reshape(b, h * w, k).float().contiguous()
    out = bilateral.gaussian_filter_apply_batched(feats.contiguous(), vals)
    return out.reshape(b, h, w, k)


class _CrfEnergy(torch.autograd.Function):
    """-sum(s * AS) / N with the reference backward -2 g AS / N (exact for
    the symmetric dense kernel); images get no gradient."""

    @staticmethod
    def forward(ctx, images, segs, sigma_rgb, sigma_xy, method):
        as_ = bilateral_filter_batch(images, segs, sigma_rgb, sigma_xy,
                                     method)
        n = float(segs.shape[0])
        ctx.save_for_backward(as_)
        ctx.n = n
        return -(segs * as_).sum() / n

    @staticmethod
    def backward(ctx, g):
        (as_,) = ctx.saved_tensors
        return None, -2.0 * g * as_ / ctx.n, None, None, None


def dense_crf_loss(images: torch.Tensor, segs: torch.Tensor,
                   sigma_rgb: float, sigma_xy: float,
                   scale_factor: float = 1.0,
                   method: str = "exact") -> torch.Tensor:
    """Spatial+color CRF loss.  images (B, H, W, 3) raw [0, 255]; segs
    (B, H, W, K) softmaxed.  scale_factor != 1 downsizes the image
    (nearest) and segs (bilinear) first and scales sigma_xy with them."""
    if scale_factor != 1.0:
        h = int(images.shape[1] * scale_factor)
        w = int(images.shape[2] * scale_factor)
        images = resize_nearest(images, (h, w))
        segs = resize_bilinear(segs, (h, w), align_corners=False)
    return _CrfEnergy.apply(images.float(), segs.float(), float(sigma_rgb),
                            float(sigma_xy * scale_factor), method)


def color_dense_crf_loss(images: torch.Tensor, segs: torch.Tensor,
                         sigma_rgb: float, scale_factor: float = 1.0,
                         method: str = "exact") -> torch.Tensor:
    """Color-only CRF loss (D = 3, no sigma_xy), the temporal joint CRF's
    kernel where a clip's frames are concatenated along width."""
    if scale_factor != 1.0:
        h = int(images.shape[1] * scale_factor)
        w = int(images.shape[2] * scale_factor)
        images = resize_nearest(images, (h, w))
        segs = resize_bilinear(segs, (h, w), align_corners=False)
    return _CrfEnergy.apply(images.float(), segs.float(), float(sigma_rgb),
                            None, method)
