"""Dense-CRF regularization (port of ops/crf.py).

AS = W s with W_ij = exp(-1/2 ||f_i - f_j||^2) over the features
f = (x/sigma_xy, y/sigma_xy, rgb/sigma_rgb); the loss is -sum(s * AS) / N
and its gradient treats AS as a constant: d loss / d s = -2 AS / N, exact
for every method here since each uses a symmetric kernel.  Methods:

- "exact": the dense filter, the CUDA kernel of ops/cuda/bilateral.py.
- "landmarks": the Nystrom factorization K_nm (K_mm + ridge I)^-1 K_mn v
  over a uniform spatial landmark grid (the JAX package's production
  stage-2 setting).  K_nm and K_mm come from the build_knm kernel of
  ops/cuda/landmarks.py; the two consumer products stay torch.bmm in full
  fp32 (in JAX they are XLA einsums outside any kernel) and the solve is
  ops/linalg.py's ("cho", or "lockstep" under TCAM_LMK_SOLVER).  With
  fused=True (or TCAM_FUSED_LANDMARKS=1) the fused two-pass nystrom_filter
  kernel runs instead and K_nm is never written.
- "rff": orthogonal random Fourier features, plain torch (the JAX package
  has no kernel for it).  torch cannot reproduce jax.random.PRNGKey(1234),
  so the port draws its own fixed frequencies from a seeded generator:
  at equal flags the port's RFF surrogate is a different (equally
  distributed) kernel estimate than the JAX package's.

Environment knobs read as in the JAX package: TCAM_FUSED_LANDMARKS ("1":
fused kernel), TCAM_LMK_GROUP (images per K_nm block, default
min(B, 32)), TCAM_KNM_DTYPE (K_nm storage, float32 or bfloat16) and
TCAM_LMK_SOLVER ("cho", the default, or "lockstep").  TCAM_KNM_BUILD and
TCAM_LMK_UNROLL have no counterpart: the card always builds K_nm with its
kernel, and eager torch already runs the groups as an unrolled loop.

The landmark filter is the span crf.landmarks of core/clock.TRACE (at
each step eagerly, at the capture on the chunked route); its K builds
count crf.knm_builds and crf.knm_mb (ops/cuda/landmarks.build_knm), its
failed factorizations crf.solve_failed (ops/linalg.py).
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.ops import linalg
from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, landmarks
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


# ------------------------------------------------------- random features
def orthogonal_frequencies(n_freq: int, d: int,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """(n_freq, d) frequencies for the unit Gaussian kernel drawn as
    orthogonal blocks (Yu et al., "Orthogonal Random Features", 2016):
    each d x d block is the Q of a Gaussian matrix with rows rescaled by
    independent chi(d) norms.  CPU, fp32."""
    nblk = -(-n_freq // d)
    g = torch.randn((nblk, d, d), generator=generator, dtype=torch.float32)
    q = torch.linalg.qr(g)[0]
    norms = torch.linalg.norm(
        torch.randn((nblk, d, d), generator=generator, dtype=torch.float32),
        dim=-1)
    return (q * norms[..., None]).reshape(nblk * d, d)[:n_freq]


@functools.lru_cache(maxsize=8)
def _fixed_frequencies(n_freq: int, d: int) -> torch.Tensor:
    """The port's fixed surrogate: frequencies from a generator seeded
    with 1234 (the JAX package's key number; not its draws)."""
    return orthogonal_frequencies(n_freq, d,
                                  torch.Generator().manual_seed(1234))


def gaussian_filter_apply_rff(feats: torch.Tensor, vals: torch.Tensor,
                              n_freq: int = 1024, chunk: int = 512,
                              omega: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """AS ~= exp(-||f_i - f_j||^2 / 2) @ vals via random Fourier features:
    Phi = [cos(f W), sin(f W)] / sqrt(n_freq), AS = Phi (Phi^T vals),
    summed over chunks of `chunk` frequencies.  omega (n_freq, D) defaults
    to the port's fixed frequencies.  feats (P, D), vals (P, K) fp32 ->
    (P, K) fp32."""
    p, d = feats.shape
    if omega is None:
        omega = _fixed_frequencies_on(int(n_freq), d, feats.device)
    omega = omega.to(device=feats.device, dtype=torch.float32)
    acc = torch.zeros((p, vals.shape[1]), dtype=torch.float32,
                      device=feats.device)
    for c0 in range(0, omega.shape[0], chunk):
        args = feats @ omega[c0:c0 + chunk].T                # (P, C)
        cosv, sinv = torch.cos(args), torch.sin(args)
        acc = acc + cosv @ (cosv.T @ vals) + sinv @ (sinv.T @ vals)
    return acc / float(omega.shape[0])


@functools.lru_cache(maxsize=8)
def _fixed_frequencies_on(n_freq: int, d: int, device: torch.device
                          ) -> torch.Tensor:
    """_fixed_frequencies copied to `device` once (a copy at each call
    would wait on the card's queue, and a CUDA graph cannot capture it)."""
    return _fixed_frequencies(n_freq, d).to(device)


# ---------------------------------------------------- landmark (Nystrom)
@functools.lru_cache(maxsize=16)
def _landmark_indices_on(h: int, w: int, m: int, device: torch.device
                         ) -> torch.Tensor:
    """_landmark_grid_indices as an int64 tensor on `device`, made once."""
    return torch.from_numpy(_landmark_grid_indices(h, w, m)).to(device)


def _landmark_grid_indices(h: int, w: int, m: int) -> np.ndarray:
    """~m flat pixel indices on a uniform spatial grid (aspect-matched);
    the same indices as the JAX package's."""
    gh = max(int(round((m * h / w) ** 0.5)), 1)
    gw = max(m // gh, 1)
    ys = np.linspace(0, h - 1, gh).round().astype(np.int64)
    xs = np.linspace(0, w - 1, gw).round().astype(np.int64)
    return (ys[:, None] * w + xs[None, :]).ravel()


def _fused_landmarks_opted_in() -> bool:
    return os.environ.get("TCAM_FUSED_LANDMARKS", "0") == "1"


def _lmk_group_default() -> Optional[int]:
    v = os.environ.get("TCAM_LMK_GROUP", "")
    return int(v) if v else None


def _knm_dtype_default() -> torch.dtype:
    name = os.environ.get("TCAM_KNM_DTYPE", "float32")
    dtype = getattr(torch, name, None)
    if dtype not in landmarks.OUT_DTYPES:
        raise ValueError(f"TCAM_KNM_DTYPE={name!r}")
    return dtype


def gaussian_filter_apply_landmarks(feats: torch.Tensor, vals: torch.Tensor,
                                    idx, ridge: float = 1e-2,
                                    group: Optional[int] = None,
                                    knm_dtype: Optional[torch.dtype] = None,
                                    fused: Optional[bool] = None
                                    ) -> torch.Tensor:
    """AS ~= K_nm (K_mm + ridge I)^-1 K_mn vals, the batched Nystrom
    filter.  feats (B, P, D) centred, vals (B, P, K) fp32, idx (M,)
    landmark pixel indices -> (B, P, K) fp32.

    Images go `group` at a time (default TCAM_LMK_GROUP or min(B, 32)),
    each group through one (G, P, M) K_nm block stored in `knm_dtype`
    (default TCAM_KNM_DTYPE or float32; bf16 operands are multiplied with
    fp32 accumulation, as the JAX einsums' preferred_element_type does).
    fused (default TCAM_FUSED_LANDMARKS == "1") runs the fused two-pass
    kernel over the whole batch instead, where K <= 8 (solving between
    its passes with the lockstep solve, as JAX's fused kernel does).  The
    build route solves with TCAM_LMK_SOLVER's solver (ops/linalg.py),
    read at each call."""
    b, _, k = vals.shape
    if not isinstance(idx, torch.Tensor):
        idx = torch.tensor(np.asarray(idx), dtype=torch.long)
    idx = idx.to(device=feats.device, dtype=torch.long)
    if fused is None:
        fused = _fused_landmarks_opted_in()
    if fused and k <= landmarks.MAX_K:
        return landmarks.nystrom_filter(feats, vals, idx, ridge)
    if knm_dtype is None:
        knm_dtype = _knm_dtype_default()
    if group is None:
        group = _lmk_group_default() or min(b, 32)
    group = min(group, b)
    outs = []
    for g0 in range(0, b, group):
        f = feats[g0:g0 + group]
        v = vals[g0:g0 + group]
        fm = f[:, idx].contiguous()
        knm = landmarks.build_knm(f, fm, out_dtype=knm_dtype)
        kmm = landmarks.add_ridge(landmarks.build_knm(fm, fm), ridge)
        if knm_dtype != torch.float32:
            knm = knm.float()
            v = v.to(knm_dtype).float()
        rhs = torch.bmm(knm.transpose(1, 2), v)             # (G, M, K)
        alpha = linalg.solve(kmm, rhs)
        if knm_dtype != torch.float32:
            alpha = alpha.to(knm_dtype).float()
        outs.append(torch.bmm(knm, alpha))                   # (G, P, K)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---------------------------------------------------------------- batch
def bilateral_filter_batch(images: torch.Tensor, segs: torch.Tensor,
                           sigma_rgb: float, sigma_xy: Optional[float],
                           method: str = "exact", rff_freqs: int = 2048,
                           n_landmarks: int = 1024) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 255]; segs (B, H, W, K) -> AS with segs'
    shape.  sigma_xy=None selects the color-only kernel."""
    b, h, w, k = segs.shape
    feats = make_bilateral_features(images, sigma_rgb, sigma_xy)
    vals = segs.reshape(b, h * w, k).float().contiguous()
    if method == "landmarks":
        with TRACE.span("crf.landmarks"):
            idx = _landmark_indices_on(h, w, n_landmarks, feats.device)
            feats = (feats - feats.mean(dim=1, keepdim=True)).contiguous()
            out = gaussian_filter_apply_landmarks(feats, vals, idx)
    elif method == "rff":
        # one image at a time: the (P, chunk) cos/sin transients stay small
        feats = feats - feats.mean(dim=1, keepdim=True)
        out = torch.stack([gaussian_filter_apply_rff(feats[i], vals[i],
                                                     n_freq=rff_freqs)
                           for i in range(b)])
    elif method == "exact":
        out = bilateral.gaussian_filter_apply_batched(feats.contiguous(),
                                                      vals)
    else:
        raise ValueError(f"unknown crf method {method!r}")
    return out.reshape(b, h, w, k)


# --------------------------------------------------------------------- loss
class _CrfEnergy(torch.autograd.Function):
    """-sum(s * AS) / N with the reference backward -2 g AS / N (exact for
    a symmetric kernel: dense, Nystrom or RFF); images get no gradient."""

    @staticmethod
    def forward(ctx, images, segs, sigma_rgb, sigma_xy, method, rff_freqs,
                n_landmarks):
        as_ = bilateral_filter_batch(images, segs, sigma_rgb, sigma_xy,
                                     method, rff_freqs, n_landmarks)
        n = float(segs.shape[0])
        ctx.save_for_backward(as_)
        ctx.n = n
        return -(segs * as_).sum() / n

    @staticmethod
    def backward(ctx, g):
        (as_,) = ctx.saved_tensors
        return None, -2.0 * g * as_ / ctx.n, None, None, None, None, None


def _downscale(images, segs, scale_factor):
    h = int(images.shape[1] * scale_factor)
    w = int(images.shape[2] * scale_factor)
    return (resize_nearest(images, (h, w)),
            resize_bilinear(segs, (h, w), align_corners=False))


def dense_crf_loss(images: torch.Tensor, segs: torch.Tensor,
                   sigma_rgb: float, sigma_xy: float,
                   scale_factor: float = 1.0, method: str = "exact",
                   rff_freqs: int = 2048,
                   n_landmarks: int = 1024) -> torch.Tensor:
    """Spatial+color CRF loss.  images (B, H, W, 3) raw [0, 255]; segs
    (B, H, W, K) softmaxed.  scale_factor != 1 downsizes the image
    (nearest) and segs (bilinear) first and scales sigma_xy with them."""
    if scale_factor != 1.0:
        images, segs = _downscale(images, segs, scale_factor)
    return _CrfEnergy.apply(images.float(), segs.float(), float(sigma_rgb),
                            float(sigma_xy * scale_factor), method,
                            int(rff_freqs), int(n_landmarks))


def color_dense_crf_loss(images: torch.Tensor, segs: torch.Tensor,
                         sigma_rgb: float, scale_factor: float = 1.0,
                         method: str = "exact", rff_freqs: int = 2048,
                         n_landmarks: int = 1024) -> torch.Tensor:
    """Color-only CRF loss (D = 3, no sigma_xy), the temporal joint CRF's
    kernel where a clip's frames are concatenated along width."""
    if scale_factor != 1.0:
        images, segs = _downscale(images, segs, scale_factor)
    return _CrfEnergy.apply(images.float(), segs.float(), float(sigma_rgb),
                            None, method, int(rff_freqs), int(n_landmarks))
