"""ctypes binding of native/bilateral_grid.cpp, the CPU bilateral-grid
filter (port of ops/native.py; the JAX package's tests hold it against
the dense filter).

The library is the JAX package's C++ built by g++ with the same flags
(core/nativebuild.py: -O3 -march=native -fopenmp -shared -fPIC) into
build/native/ at first use, so both packages compute the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from tcam_wsol_video_tpu_torch.core import nativebuild

_FP = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = nativebuild.load("bilateral_grid")
    lib.bilateral_filter_batch.argtypes = [
        _FP, _FP, _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.bilateral_filter_batch.restype = None
    lib.color_bilateral_filter_batch.argtypes = [
        _FP, _FP, _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]
    lib.color_bilateral_filter_batch.restype = None
    return lib


def bilateral_filter_batch_native(images: np.ndarray, segs: np.ndarray,
                                  sigma_rgb: float,
                                  sigma_xy: Optional[float]) -> np.ndarray:
    """images (N, H, W, 3) float32 in [0, 255]; segs (N, H, W, K) float32.
    Returns the filtered segs; sigma_xy None filters on colour alone."""
    images = np.ascontiguousarray(images, np.float32)
    segs = np.ascontiguousarray(segs, np.float32)
    n, h, w, k = segs.shape
    out = np.zeros_like(segs)
    lib = _lib()
    if sigma_xy is None:
        lib.color_bilateral_filter_batch(
            images.ctypes.data_as(_FP), segs.ctypes.data_as(_FP),
            out.ctypes.data_as(_FP), n, k, h, w, ctypes.c_float(sigma_rgb))
    else:
        lib.bilateral_filter_batch(
            images.ctypes.data_as(_FP), segs.ctypes.data_as(_FP),
            out.ctypes.data_as(_FP), n, k, h, w, ctypes.c_float(sigma_rgb),
            ctypes.c_float(sigma_xy))
    return out
