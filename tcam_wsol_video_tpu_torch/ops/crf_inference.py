"""Inference-time dense-CRF refinement by mean field (port of
ops/crf_inference.py), on the exact bilateral filter of the CRF loss:

    Q0 = softmax(-U);  repeat T times:
        m = w_app (W_bilateral Q - Q) + w_smooth (W_spatial Q - Q)
        Q = softmax(-U + m)            (Potts compatibility, mu = -1)

(Krahenbuhl & Koltun 2011, eq. 4-6; subtracting Q removes the
self-connection W_ii = 1.)  Two filter launches per iteration.
"""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.ops.crf import bilateral_filter_batch


@torch.no_grad()
def mean_field_refine(images: torch.Tensor, probs: torch.Tensor,
                      num_iters: int = 5, sigma_rgb: float = 13.0,
                      sigma_xy: float = 80.0, sigma_smooth: float = 3.0,
                      w_app: float = 10.0,
                      w_smooth: float = 3.0) -> torch.Tensor:
    """images (B, H, W, 3) raw [0, 255]; probs (B, H, W, K) initial class
    probabilities.  Returns the refined probabilities."""
    unary = -torch.log(probs.float().clamp_min(1e-8))
    zeros = torch.zeros_like(images, dtype=torch.float32)
    q = torch.softmax(-unary, dim=-1)
    for _ in range(num_iters):
        app = bilateral_filter_batch(images, q, sigma_rgb, sigma_xy)
        smooth = bilateral_filter_batch(zeros, q, 1.0, sigma_smooth)
        msg = w_app * (app - q) + w_smooth * (smooth - q)
        q = torch.softmax(-unary + msg, dim=-1)
    return q
