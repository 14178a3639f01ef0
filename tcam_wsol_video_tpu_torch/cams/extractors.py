"""CAM extractors (port of cams/extractors.py): the TCAM eval path's
decoder CAM and the stage-1 classifier's fc-weight CAM."""
from __future__ import annotations

import torch


def normalize_minmax(cam: torch.Tensor) -> torch.Tensor:
    """Per-map min-max normalization over the last two axes."""
    mn = cam.amin(dim=(-2, -1), keepdim=True)
    mx = cam.amax(dim=(-2, -1), keepdim=True)
    return (cam - mn) / (mx - mn)


def seg_cam(fcams: torch.Tensor) -> torch.Tensor:
    """Softmax foreground channel of the 2-channel decoder output.
    fcams (B, H, W, 2) -> (B, H, W)."""
    return torch.softmax(fcams, dim=-1)[..., 1]


def _finalize(cam: torch.Tensor) -> torch.Tensor:
    """Min-max normalization, then nan -> 0, +inf -> 1, -inf -> 0 (a
    constant map normalizes to NaN and so becomes 0).  No ReLU before it
    (the reference's CAM keeps its default `_relu=False`): negative-sum
    regions scale into [0, 1] rather than clamp to 0."""
    return torch.nan_to_num(normalize_minmax(cam), nan=0.0, posinf=1.0,
                            neginf=0.0)


def _weighted_cam(feats: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """sum_k w_k A_k over channels with nansum semantics: a NaN weight
    drops its channel.  feats (B, C, h, w), weights (B, C) -> (B, h, w),
    in the promoted dtype of the two (bf16 features and fp32 weights give
    fp32, as in JAX)."""
    dtype = torch.promote_types(feats.dtype, weights.dtype)
    weights = weights.masked_fill(weights.isnan(), 0.0)
    return _finalize(torch.einsum("bchw,bc->bhw", feats.to(dtype),
                                  weights.to(dtype)))


def cam_fc_weights(feats: torch.Tensor, fc_weight: torch.Tensor,
                   class_idx: torch.Tensor, support_background: bool = False
                   ) -> torch.Tensor:
    """Classic CAM: the channel weights are the fc row of the target class
    (one row further with a background class).  feats (B, C, h, w);
    fc_weight (classes, C), the nn.Linear layout; class_idx (B,).  An
    index past the last row reads the last row, as JAX's gather clamps it
    (the WGAP head has no background row)."""
    idx = class_idx.long() + (1 if support_background else 0)
    return _weighted_cam(feats, fc_weight[idx.clamp(max=fc_weight.shape[0]
                                                    - 1)])
