"""The landmark (Nystrom) CRF term of the production stage-2 recipe, plain.

The energy and its backward are reference/losses.crf's: -sum(s * AS) / B
over the softmax maps s and d/ds = -2 AS / B.  AS is the Nystrom filter

    AS = K_nm (K_mm + ridge I)^-1 K_mn s,   ridge = 1e-2,

with K_ij = exp(-||f_i - f_j||^2 / 2) over reference/losses.crf_features
(x, y over sigma_xy, rgb over sigma_rgb, centred per image) and the M
landmarks on a uniform spatial grid (`landmark_grid`, a copy of the
program's grid rule: round(sqrt(M H / W)) rows, M // rows columns, each
axis np.linspace(0, side - 1, n).round()).

Where it departs from the program's landmark route (tcam_wsol_video_tpu_
torch/ops/crf.py), on purpose:
- the features come from crf_features, centred in float64 and rounded to
  fp32 once; the program makes and centres them in fp32;
- every kernel entry is exp(-d2 / 2) of the direct feature differences in
  float64, a block of rows of K_nm at a time (built twice: once for
  K_mn s, once for K_nm alpha); the program writes the whole fp32 K_nm
  with its kernel, from the norm expansion of d2 and a fast exp2;
- K_mm + ridge I is factored (torch.linalg.cholesky) and solved
  (torch.cholesky_solve) in float64, and a failed factorization raises;
  the program factors in fp32 with cholesky_ex and counts failures on the
  card;
- both products are float64; the program's are fp32 batched products;
- one image at a time; the program takes the batch in groups.
The result is rounded to fp32 once, at the end.  TF32 is set off around
the filter, as reference/losses.dense_filter sets it, though every
product here is float64."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark.reference.losses import crf_features

RIDGE = 1e-2
BLOCK_ROWS = 4096


def landmark_grid(h: int, w: int, m: int) -> np.ndarray:
    """About m flat pixel indices on a uniform grid matched to h / w."""
    gh = max(int(round((m * h / w) ** 0.5)), 1)
    gw = max(m // gh, 1)
    ys = np.linspace(0, h - 1, gh).round().astype(np.int64)
    xs = np.linspace(0, w - 1, gw).round().astype(np.int64)
    return (ys[:, None] * w + xs[None, :]).ravel()


def _kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(-||a_i - b_j||^2 / 2) of float64 rows a (R, D), b (M, D)."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return torch.exp(-0.5 * d2)


def nystrom_filter(feats: torch.Tensor, vals: torch.Tensor, idx,
                   ridge: float = RIDGE, block: int = BLOCK_ROWS
                   ) -> torch.Tensor:
    """AS for feats (B, P, D), vals (B, P, K) and landmark indices idx
    (M,) -> (B, P, K) fp32."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                          device=feats.device)
    out = torch.empty(vals.shape, dtype=torch.float32, device=vals.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(feats.shape[0]):
            out[i] = _one_image(feats[i], vals[i], idx, ridge, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _one_image(f: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
               ridge: float, block: int) -> torch.Tensor:
    f, v = f.double(), v.double()
    fm = f[idx]
    kmm = _kernel(fm, fm)
    kmm.diagonal().add_(ridge)
    rhs = torch.zeros((fm.shape[0], v.shape[1]), dtype=torch.float64,
                      device=f.device)
    for r0 in range(0, f.shape[0], block):
        rhs += _kernel(f[r0:r0 + block], fm).T @ v[r0:r0 + block]
    alpha = torch.cholesky_solve(rhs, torch.linalg.cholesky(kmm))
    return torch.cat([_kernel(f[r0:r0 + block], fm) @ alpha
                      for r0 in range(0, f.shape[0], block)]).float()


class _CrfEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, probs, idx):
        b, h, w, k = probs.shape
        ws = nystrom_filter(feats, probs.reshape(b, h * w, k).float(), idx
                            ).reshape(probs.shape)
        ctx.save_for_backward(ws)
        return -(probs * ws).sum() / float(b)

    @staticmethod
    def backward(ctx, g):
        (ws,) = ctx.saved_tensors
        return None, -2.0 * g * ws / float(ws.shape[0]), None


def crf(fcams: torch.Tensor, raw: torch.Tensor, sigma_rgb: float,
        sigma_xy: float, feats: Optional[torch.Tensor] = None,
        n_landmarks: int = 1024):
    """reference/losses.crf's term with the Nystrom filter over
    n_landmarks grid landmarks."""
    probs = torch.softmax(fcams.float(), dim=-1)
    if feats is None:
        feats = crf_features(raw, sigma_rgb, sigma_xy)
    idx = landmark_grid(raw.shape[1], raw.shape[2], n_landmarks)
    return _CrfEnergy.apply(feats, probs, idx)
