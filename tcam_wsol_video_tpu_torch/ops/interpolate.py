"""Bilinear / nearest resizing as separable matmuls (port of
ops/interpolate.py).

The matrix builders are copied from the JAX package, so both packages
resample with the same weights: exact torch align_corners conventions,
including the fused nearest-then-bilinear decoder snap.  The public
functions take NHWC tensors like their JAX counterparts; `layout="nchw"`
serves the models, which run NCHW inside.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """Row r holds the source weights producing output sample r."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        # torch convention: single output sample reads source 0 when
        # align_corners else the half-pixel mapped (clamped) source.
        if align_corners or n_in == 1:
            m[0, 0] = 1.0
            return m
    for r in range(n_out):
        if align_corners:
            src = r * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = (r + 0.5) * n_in / n_out - 0.5
            src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w_hi = src - lo
        m[r, lo] += 1.0 - w_hi
        m[r, hi] += w_hi
    return m


@functools.lru_cache(maxsize=256)
def _nearest_matrix(n_in: int, n_out: int) -> np.ndarray:
    """torch 'nearest' convention: src = floor(r * n_in / n_out)."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for r in range(n_out):
        src = min(int(r * n_in / n_out), n_in - 1)
        m[r, src] = 1.0
    return m


def _hw(x: torch.Tensor, layout: str):
    if layout == "nhwc":
        return x.shape[-3], x.shape[-2]
    if layout == "nchw":
        return x.shape[-2], x.shape[-1]
    raise ValueError(layout)


def _apply_separable(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray,
                     layout: str) -> torch.Tensor:
    """mh @ x @ mw^T over the spatial axes of x."""
    a = torch.as_tensor(mh, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(mw, dtype=x.dtype, device=x.device)
    if layout == "nhwc":
        y = torch.einsum("ph,...hwc->...pwc", a, x)
        return torch.einsum("qw,...pwc->...pqc", b, y)
    y = torch.einsum("ph,...hw->...pw", a, x)
    return torch.einsum("qw,...pw->...pq", b, y)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False,
                    layout: str = "nhwc") -> torch.Tensor:
    """Bilinear resize to `size`, numerically torch's
    interpolate(mode='bilinear') with the given align_corners."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = _hw(x, layout)
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _apply_separable(x, _linear_matrix(h_in, h_out, align_corners),
                            _linear_matrix(w_in, w_out, align_corners),
                            layout)


def resize_nearest(x: torch.Tensor, size, layout: str = "nhwc"
                   ) -> torch.Tensor:
    """Nearest resize, matching torch mode='nearest'."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = _hw(x, layout)
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _apply_separable(x, _nearest_matrix(h_in, h_out),
                            _nearest_matrix(w_in, w_out), layout)


def resize_nearest_then_bilinear(x: torch.Tensor, mid, size,
                                 align_corners: bool = True,
                                 layout: str = "nhwc") -> torch.Tensor:
    """Fused nearest(in->mid) then bilinear(mid->size) resize: one matrix
    per axis, composed in fp64 before the cast (the JAX package's
    construction, so both packages use identical weights)."""
    mid_h, mid_w = int(mid[0]), int(mid[1])
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = _hw(x, layout)
    mh = (_linear_matrix(mid_h, h_out, align_corners).astype(np.float64)
          @ _nearest_matrix(h_in, mid_h).astype(np.float64)
          ).astype(np.float32)
    mw = (_linear_matrix(mid_w, w_out, align_corners).astype(np.float64)
          @ _nearest_matrix(w_in, mid_w).astype(np.float64)
          ).astype(np.float32)
    return _apply_separable(x, mh, mw, layout)
