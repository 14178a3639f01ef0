"""ctypes binding of csrc/contours.cpp: the borders that cv2.findContours
(RETR_TREE, CHAIN_APPROX_SIMPLE) returns on a thresholded uint8 map, in
cv2's order, with contourArea's area and boundingRect's rectangle.

`sweep` gives, for each threshold level, the first border of largest area
(the single-largest-contour protocol: Python's max over cv2's list) or
every border.  A level is traced once however many taus map to it, so a
sweep of 1000 taus over a map whose peak is 255 traces at most 256 masks.
Built by g++ at first use (core/nativebuild.py); a missing compiler
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.core import nativebuild

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = nativebuild.load("contours")
    lib.contour_sweep.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _I32P,
                                  ctypes.c_int, ctypes.c_int, _I64P,
                                  ctypes.c_int64]
    lib.contour_sweep.restype = ctypes.c_int64
    lib.trace_contours.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _I32P, ctypes.c_int64,
                                   _I32P, ctypes.c_int64]
    lib.trace_contours.restype = ctypes.c_int64
    return lib


def sweep(img8: np.ndarray, levels: np.ndarray, multi: bool) -> np.ndarray:
    """img8 (H, W) uint8; levels (L,) thresholds (mask = img8 > level).
    Returns int64 rows (level index, x, y, width, height, doubled area):
    per level the first largest border (multi False) or every border in
    cv2's order (multi True); a level with no border has no row."""
    img8 = np.ascontiguousarray(img8, np.uint8)
    if img8.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {img8.shape}")
    h, w = img8.shape
    lv = np.ascontiguousarray(levels, np.int32)
    cap = max(64, 4 * len(lv))
    while True:
        out = np.empty((cap, 6), np.int64)
        n = _lib().contour_sweep(img8.ctypes.data_as(_U8P), h, w,
                                 lv.ctypes.data_as(_I32P), len(lv),
                                 int(bool(multi)), out.ctypes.data_as(_I64P),
                                 cap)
        if n <= cap:
            return out[:n]
        cap = int(n)


def trace(img8: np.ndarray, level: int
          ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The borders of img8 > level as cv2.findContours(RETR_TREE,
    CHAIN_APPROX_SIMPLE) gives them: (list of (n_i, 2) int32 point arrays,
    (n, 2) int32 of (parent index or -1, is_hole))."""
    img8 = np.ascontiguousarray(img8, np.uint8)
    h, w = img8.shape
    pts_cap, meta_cap = 4 * h * w + 16, h * w + 16
    pts = np.empty((pts_cap, 2), np.int32)
    meta = np.empty((meta_cap, 4), np.int32)
    n = _lib().trace_contours(img8.ctypes.data_as(_U8P), h, w, int(level),
                              pts.ctypes.data_as(_I32P), pts_cap,
                              meta.ctypes.data_as(_I32P), meta_cap)
    if n < 0:
        raise RuntimeError("trace_contours: buffers too small")
    contours = [pts[s:s + c].copy() for s, c, _, _ in meta[:n]]
    return contours, meta[:n, 2:].copy()
