"""ctypes binding of native/boxsweep.cpp, the exact all-threshold
contour-box sweep of the evaluation protocol (port of
metrics/native_sweep.py, same signatures).

One union-find pass per image gives, for every threshold tau, the boxes
that cv2's threshold + findContours + boundingRect would give on the
uint8-rendered CAM, and folds in the (+1-pixel) IoU against the GT boxes,
so a batch of CAMs is one C call.  Built by g++ at first use
(core/nativebuild.py); a missing compiler raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.core import nativebuild

_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = nativebuild.load("boxsweep")
    lib.sweep_best_iou.argtypes = [
        _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _DP, ctypes.c_int, _FP, _IP, ctypes.c_int, _DP, _IP]
    lib.sweep_best_iou.restype = ctypes.c_int
    lib.sweep_boxes_at.argtypes = [
        _FP, ctypes.c_int, ctypes.c_int, ctypes.c_double, _FP, ctypes.c_int]
    lib.sweep_boxes_at.restype = ctypes.c_int
    return lib


def sweep_best_iou(cams: np.ndarray, taus: Sequence[float],
                   gt_boxes_list: List[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """cams: (n, h, w) float32 in [0, 1]; gt_boxes_list[i]: (g_i, 4).
    Returns (best_iou (n, n_tau) float64, n_boxes (n, n_tau) int32)."""
    cams = np.ascontiguousarray(cams, np.float32)
    n, h, w = cams.shape
    if len(gt_boxes_list) != n:
        raise ValueError(f"{n} CAMs but {len(gt_boxes_list)} GT box lists")
    taus_a = np.ascontiguousarray(taus, np.float64)
    max_gt = max((len(g) for g in gt_boxes_list), default=1) or 1
    gt = np.zeros((n, max_gt, 4), np.float32)
    cnt = np.zeros((n,), np.int32)
    for i, g in enumerate(gt_boxes_list):
        g = np.asarray(g, np.float32).reshape(-1, 4)
        gt[i, :len(g)] = g
        cnt[i] = len(g)
    best = np.zeros((n, len(taus_a)), np.float64)
    nbox = np.zeros((n, len(taus_a)), np.int32)
    rc = _lib().sweep_best_iou(
        cams.ctypes.data_as(_FP), n, h, w, taus_a.ctypes.data_as(_DP),
        len(taus_a), gt.ctypes.data_as(_FP), cnt.ctypes.data_as(_IP),
        max_gt, best.ctypes.data_as(_DP), nbox.ctypes.data_as(_IP))
    if rc != 0:
        raise RuntimeError(f"sweep_best_iou returned {rc}")
    return best, nbox


def sweep_boxes_at(cam: np.ndarray, tau: float,
                   cap: int = 65536) -> np.ndarray:
    """All contour boxes of one CAM at one threshold."""
    cam = np.ascontiguousarray(cam, np.float32)
    h, w = cam.shape
    out = np.zeros((cap, 4), np.float32)
    nb = _lib().sweep_boxes_at(cam.ctypes.data_as(_FP), h, w,
                               ctypes.c_double(tau), out.ctypes.data_as(_FP),
                               cap)
    if nb > cap:
        raise RuntimeError(f"{nb} boxes exceed the buffer of {cap}")
    return out[:nb]
