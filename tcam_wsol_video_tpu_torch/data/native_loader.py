"""ctypes binding of native/fastloader.cpp, the host image route: libjpeg
decode, half-pixel bilinear resize, crop, flip and ImageNet normalization
of a batch in one OpenMP call (port of data/native_loader.py, signatures
of its load_batch).

The library is built from the checkout's native/fastloader.cpp with the
JAX binding's g++ flags (core/nativebuild.py), so both packages decode the
same bits.  It needs libjpeg; where that is missing the build raises.  The
card's route is data/nvjpeg_loader.py.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.core import nativebuild

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_ubyte)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = nativebuild.load("fastloader")
    lib.load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _IP, _IP, _UP, _FP, _FP]
    lib.load_batch.restype = ctypes.c_int
    lib.decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _UP]
    lib.decode_resize_batch.restype = ctypes.c_int
    return lib


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def load_batch(paths: List[str], resize: int, crop: int,
               xs: Optional[np.ndarray] = None,
               ys: Optional[np.ndarray] = None,
               flips: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, resize to (resize, resize), crop at (ys, xs), flip and
    normalize a batch.  Returns (normalized (N, crop, crop, 3), raw
    (N, crop, crop, 3) in [0, 255]), float32."""
    n = len(paths)
    xs = np.ascontiguousarray(np.zeros(n) if xs is None else xs, np.int32)
    ys = np.ascontiguousarray(np.zeros(n) if ys is None else ys, np.int32)
    flips = np.ascontiguousarray(np.zeros(n) if flips is None else flips,
                                 np.uint8)
    out_norm = np.empty((n, crop, crop, 3), np.float32)
    out_raw = np.empty((n, crop, crop, 3), np.float32)
    rc = _lib().load_batch(
        _paths(paths), n, resize, resize, crop, xs.ctypes.data_as(_IP),
        ys.ctypes.data_as(_IP), flips.ctypes.data_as(_UP),
        out_norm.ctypes.data_as(_FP), out_raw.ctypes.data_as(_FP))
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return out_norm, out_raw


def decode_u8(paths: List[str], height: int, width: int) -> np.ndarray:
    """Decode and resize to (N, height, width, 3) uint8 (rounded); at the
    frames' own size this is the plain decode."""
    n = len(paths)
    buf = np.empty((n, height, width, 3), np.uint8)
    rc = _lib().decode_resize_batch(_paths(paths), n, height, width,
                                    buf.ctypes.data_as(_UP))
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return buf
