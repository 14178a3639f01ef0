"""CAM extractors (port of cams/extractors.py): the TCAM eval path's
decoder CAM and the thirteen CAM methods of the stage-1 classifier.

Features are NCHW here: feats (B, C, h, w), the last encoder feature;
images (B, H, W, 3) as the model takes them; class_idx (B,).  Every
method returns (B, h, w) maps min-max normalized into [0, 1] with the
eval pipeline's nan guard (_finalize).

- CAM (fc-weight) and the built-in heads' maps (GAP, MaxPool, LSE,
  WildCat) apply no ReLU before the normalization, as the reference.
- The gradient methods differentiate the pooling head alone with respect
  to the feature (head_fn(feat) -> logits): one autograd.grad of the sum
  of the target logits for the batch, grad enabled around the head only
  (the eval step runs under no_grad) and no parameter gradient kept.
  GradCAM++ keeps the reference's no-op alpha division unless
  corrected_alpha; SmoothGradCAM++ weights the LAST noisy forward's
  activations, and its alpha's denominator uses the CLEAN activations.
- The ScoreCAM family masks the input with each activation channel,
  min-max normalized at feature resolution BEFORE the bilinear upsample,
  scores the masked inputs `batch_chunk` channels at a time (one batched
  forward a chunk), weights each channel by its target-class softmax
  probability, and sums over the NORMALIZED activations; zero-range
  channels get weight 0.  SSCAM adds its noise to the mask and averages
  over samples; ISCAM scales the masked input by cumulative coefficients
  and sums over samples.

The noise of SmoothGradCAM++ and SSCAM is drawn from the generator given
(on the images' device), or passed in as `noise` so that two runs can
share the draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear

HeadFn = Callable[[torch.Tensor], torch.Tensor]

# the methods that read the maps of a head that builds them
BUILTIN_CAM_METHODS = (constants.METHOD_GAP, constants.METHOD_MAXPOOL,
                       constants.METHOD_LSE, constants.METHOD_WILDCAT)


def normalize_minmax(cam: torch.Tensor) -> torch.Tensor:
    """Per-map min-max normalization over the last two axes."""
    mn = cam.amin(dim=(-2, -1), keepdim=True)
    mx = cam.amax(dim=(-2, -1), keepdim=True)
    return (cam - mn) / (mx - mn)


def seg_cam(fcams: torch.Tensor) -> torch.Tensor:
    """Softmax foreground channel of the 2-channel decoder output.
    fcams (B, H, W, 2) -> (B, H, W)."""
    return torch.softmax(fcams, dim=-1)[..., 1]


def _finalize(cam: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Optional ReLU, min-max normalization, then nan -> 0, +inf -> 1,
    -inf -> 0 (a constant map normalizes to NaN and so becomes 0)."""
    if relu:
        cam = torch.relu(cam)
    return torch.nan_to_num(normalize_minmax(cam), nan=0.0, posinf=1.0,
                            neginf=0.0)


def _weighted_cam(feats: torch.Tensor, weights: torch.Tensor,
                  relu: bool = True) -> torch.Tensor:
    """sum_k w_k A_k over channels with nansum semantics: a NaN weight
    drops its channel.  feats (B, C, h, w), weights (B, C) -> (B, h, w),
    in the promoted dtype of the two (bf16 features and fp32 weights give
    fp32, as in JAX)."""
    dtype = torch.promote_types(feats.dtype, weights.dtype)
    weights = weights.masked_fill(weights.isnan(), 0.0)
    return _finalize(torch.einsum("bchw,bc->bhw", feats.to(dtype),
                                  weights.to(dtype)), relu)


def cam_fc_weights(feats: torch.Tensor, fc_weight: torch.Tensor,
                   class_idx: torch.Tensor, support_background: bool = False
                   ) -> torch.Tensor:
    """Classic CAM: the channel weights are the fc row of the target class
    (one row further with a background class), no ReLU.  fc_weight
    (classes, C), the nn.Linear layout.  An index past the last row reads
    the last row, as JAX's gather clamps it (the WGAP head has no
    background row)."""
    idx = class_idx.long() + (1 if support_background else 0)
    return _weighted_cam(feats, fc_weight[idx.clamp(max=fc_weight.shape[0]
                                                    - 1)], relu=False)


def builtin_cam(cams_head: torch.Tensor, class_idx: torch.Tensor,
                support_background: bool = False) -> torch.Tensor:
    """A map-building head's map of the target class (index + 1 with the
    background class), no ReLU.  cams_head (B, K, h, w)."""
    idx = class_idx.long() + (1 if support_background else 0)
    cam = cams_head[torch.arange(cams_head.shape[0],
                                 device=cams_head.device), idx]
    return _finalize(cam, relu=False)


# ------------------------------------------------------------ grad CAMs
def _class_grads(head_fn: HeadFn, feats: torch.Tensor,
                 class_idx: torch.Tensor) -> torch.Tensor:
    """d logits[class] / d feats for each sample: one autograd.grad of
    the sum of the target logits over the batch (the samples do not
    interact), with grad enabled around the head alone."""
    f = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = head_fn(f)
        target = logits.gather(1, class_idx.long()[:, None]).sum()
        (g,) = torch.autograd.grad(target, f)
    return g


def grad_cam(head_fn: HeadFn, feats: torch.Tensor,
             class_idx: torch.Tensor) -> torch.Tensor:
    """GradCAM: w_k = spatial mean of the gradient; ReLU."""
    g = _class_grads(head_fn, feats, class_idx)
    return _weighted_cam(feats, g.mean(dim=(2, 3)))


def grad_cam_pp(head_fn: HeadFn, feats: torch.Tensor,
                class_idx: torch.Tensor,
                corrected_alpha: bool = False) -> torch.Tensor:
    """GradCAM++: w_k = sum_hw alpha relu(g).  The reference's alpha
    division never reaches alpha (an in-place divide of a copy), so its
    alpha is g^2; corrected_alpha applies the paper's
    g^2 / (2 g^2 + sum_hw A g^3)."""
    g = _class_grads(head_fn, feats, class_idx)
    g2 = g * g
    if corrected_alpha:
        denom = 2.0 * g2 + (g2 * g * feats).sum(dim=(2, 3), keepdim=True)
        alpha = torch.where(g2 > 0, g2 / torch.where(denom == 0, 1.0, denom),
                            0.0)
    else:
        alpha = g2
    return _weighted_cam(feats, (alpha * torch.relu(g)).sum(dim=(2, 3)))


def _normal(shape, generator: Optional[torch.Generator],
            like: torch.Tensor) -> torch.Tensor:
    if generator is None:
        raise ValueError("the method draws noise: pass a generator or the "
                         "noise")
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def smooth_grad_cam_pp(forward_feats_fn: Callable, head_fn: HeadFn,
                       images: torch.Tensor, class_idx: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       num_samples: int = 4, std: float = 0.3,
                       noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """SmoothGradCAM++: num_samples noisy forwards (images + noise)
    average g^2 and g^3; alpha = mean g^2 / (2 mean g^2 + sum_hw(mean g^3
    A_clean)), 0 where the denominator is 0; w_k = sum_hw alpha
    relu(g_last), over the last noisy forward's activations.  noise
    (num_samples, *images.shape), else std times a normal draw from
    `generator`."""
    feats0 = forward_feats_fn(images)
    if noise is None:
        noise = std * _normal((num_samples,) + tuple(images.shape),
                              generator, images)
    g2 = g3 = g = f = None
    for n in noise:
        f = forward_feats_fn(images + n)
        g = _class_grads(head_fn, f, class_idx)
        gg = g * g
        g2 = gg if g2 is None else g2 + gg
        g3 = gg * g if g3 is None else g3 + gg * g
    g2 = g2 / len(noise)
    g3 = g3 / len(noise)
    denom = 2.0 * g2 + (g3 * feats0).sum(dim=(2, 3), keepdim=True)
    alpha = torch.where(denom != 0,
                        g2 / torch.where(denom == 0, 1.0, denom), 0.0)
    return _weighted_cam(f, (alpha * torch.relu(g)).sum(dim=(2, 3)))


def xgrad_cam(head_fn: HeadFn, feats: torch.Tensor,
              class_idx: torch.Tensor) -> torch.Tensor:
    """XGradCAM: w_k = sum_hw(g A) / sum_hw(A), 0 for a zero-sum
    channel."""
    g = _class_grads(head_fn, feats, class_idx)
    num = (g * feats).sum(dim=(2, 3))
    den = feats.sum(dim=(2, 3))
    return _weighted_cam(feats, torch.where(
        den == 0, 0.0, num / torch.where(den == 0, 1.0, den)))


def layer_cam(head_fn: HeadFn, feats: torch.Tensor,
              class_idx: torch.Tensor) -> torch.Tensor:
    """LayerCAM: relu(sum_k relu(g_k) A_k), normalized."""
    g = _class_grads(head_fn, feats, class_idx)
    return _finalize((torch.relu(g) * feats).sum(dim=1), relu=True)


# ---------------------------------------------------------- score CAMs
def _upsampled_masks(feats: torch.Tensor, images: torch.Tensor):
    """Each channel min-max normalized at feature resolution, then
    upsampled bilinearly (align_corners=False) to the input's size.
    Returns the normalized features (B, C, h, w) (the weighted sum runs
    over them), the masks (B, C, H, W) and the zero-range channels
    (B, C)."""
    mn = feats.amin(dim=(2, 3), keepdim=True)
    mx = feats.amax(dim=(2, 3), keepdim=True)
    zero_rng = (mx - mn) == 0
    masks_feat = (feats - mn) / torch.where(zero_rng, 1.0, mx - mn)
    masks = resize_bilinear(masks_feat, tuple(images.shape[1:3]),
                            align_corners=False, layout="nchw")
    return masks_feat, masks, zero_rng[:, :, 0, 0]


def _class_probs_chunked(forward_logits_fn: Callable, masks: torch.Tensor,
                         images: torch.Tensor, class_idx: torch.Tensor,
                         batch_chunk: int,
                         noise: Optional[torch.Tensor] = None,
                         scale=1.0) -> torch.Tensor:
    """The target-class softmax probability of each (sample, channel)
    masked input scale (images (mask + noise)), `batch_chunk` channels of
    every sample through one forward.  masks (B, C, H, W); noise
    (B, H, W, 3) is added to the mask (SSCAM).  Returns (B, C)."""
    b, c = masks.shape[:2]
    if c % batch_chunk:
        raise ValueError(f"{c} channels in chunks of {batch_chunk}")
    idx = class_idx.long()[:, None, None].expand(b, batch_chunk, 1)
    out = []
    for s in range(0, c, batch_chunk):
        m = masks[:, s:s + batch_chunk, :, :, None]
        if noise is not None:
            m = m + noise[:, None]
        masked = scale * (images[:, None] * m)        # (B, chunk, H, W, 3)
        logits = forward_logits_fn(masked.reshape((-1,) + images.shape[1:]))
        probs = torch.softmax(logits, dim=-1).reshape(b, batch_chunk, -1)
        out.append(probs.gather(2, idx)[..., 0])
    return torch.cat(out, dim=1)


def score_cam(forward_logits_fn: Callable, images: torch.Tensor,
              feats: torch.Tensor, class_idx: torch.Tensor,
              batch_chunk: int = 32) -> torch.Tensor:
    """ScoreCAM: w_k = the target probability of the input masked by
    channel k; ReLU."""
    masks_feat, masks, zero_rng = _upsampled_masks(feats, images)
    w = _class_probs_chunked(forward_logits_fn, masks, images, class_idx,
                             batch_chunk)
    return _weighted_cam(masks_feat, w.masked_fill(zero_rng, 0.0))


def sscam(forward_logits_fn: Callable, images: torch.Tensor,
          feats: torch.Tensor, class_idx: torch.Tensor,
          generator: Optional[torch.Generator] = None,
          num_samples: int = 35, std: float = 2.0, batch_chunk: int = 32,
          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Smoothed ScoreCAM: input (mask + delta), one delta a sample shared
    by the channels, probabilities averaged over the samples.  noise
    (num_samples, *images.shape), else std times a normal draw from
    `generator`."""
    masks_feat, masks, zero_rng = _upsampled_masks(feats, images)
    if noise is None:
        noise = std * _normal((num_samples,) + tuple(images.shape),
                              generator, images)
    w = torch.stack([_class_probs_chunked(forward_logits_fn, masks, images,
                                          class_idx, batch_chunk, noise=n)
                     for n in noise]).mean(dim=0)
    return _weighted_cam(masks_feat, w.masked_fill(zero_rng, 0.0))


def iscam(forward_logits_fn: Callable, images: torch.Tensor,
          feats: torch.Tensor, class_idx: torch.Tensor,
          num_samples: int = 10, batch_chunk: int = 32) -> torch.Tensor:
    """Integrated ScoreCAM: sample i scores the masked input times
    sum_{j <= i} (j + 1) / N; the probabilities are summed."""
    masks_feat, masks, zero_rng = _upsampled_masks(feats, images)
    coefs = torch.cumsum((torch.arange(num_samples, dtype=images.dtype,
                                       device=images.device) + 1.0)
                         / num_samples, dim=0)
    w = torch.stack([_class_probs_chunked(forward_logits_fn, masks, images,
                                          class_idx, batch_chunk, scale=c)
                     for c in coefs]).sum(dim=0)
    return _weighted_cam(masks_feat, w.masked_fill(zero_rng, 0.0))


def build_std_extractor(method: str):
    """The extractor function of a CAM method."""
    table = {
        constants.METHOD_CAM: cam_fc_weights,
        constants.METHOD_GRADCAM: grad_cam,
        constants.METHOD_GRADCAMPP: grad_cam_pp,
        constants.METHOD_SMOOTHGRADCAMPP: smooth_grad_cam_pp,
        constants.METHOD_XGRADCAM: xgrad_cam,
        constants.METHOD_LAYERCAM: layer_cam,
        constants.METHOD_SCORECAM: score_cam,
        constants.METHOD_SSCAM: sscam,
        constants.METHOD_ISCAM: iscam,
        constants.METHOD_GAP: builtin_cam,
        constants.METHOD_MAXPOOL: builtin_cam,
        constants.METHOD_LSE: builtin_cam,
        constants.METHOD_WILDCAT: builtin_cam,
    }
    return table[method]
