"""The train data plane of the recipe, from the benchmark's own inputs (a
frozen copy of the JAX package's sampling streams and geometry).

An epoch e of a train split of shots (each a list of frame ids) takes the
shots in the order numpy_rng(seed, "shuffle", "train", e).permutation, in
batches; a shot's frame is numpy_rng(seed, "data", "train", e, index)
.integers(0, frames); its crop numpy_rng(seed, "aug", "train", e, index,
0): row, then column, each integers(0, resize - crop + 1), then a
horizontal flip where random() < 0.5.  The pixels are the frame resized to
(resize, resize) bilinearly (half-pixel centres, edges clamped), then
cropped and flipped.  The seed CAM fuses the stored CAMs of the frame and
its neighbours in the shot (sl_tc_knn frames before and after, a shot's
last frame counting itself as its right neighbour), each heated to
exp((cam + 1e-6) t) / max, by their maximum; it is resized to
(resize, resize) with torch's bilinear (align_corners False), cropped,
flipped and clipped to [0, 1].  Its ROI is the pixels where 255 cam
reaches skimage's 256-bin Otsu threshold of floor(255 cam)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from benchmark.reference.keychain import numpy_rng
from benchmark.reference.model import linear_matrix

LUMA = np.array([0.299, 0.587, 0.114])


def epoch_plan(seed: int, epoch: int, shots: Sequence[str],
               frames_of: Dict[str, List[str]], labels: Dict[str, int],
               batch_size: int, resize: int, crop: int, steps: int
               ) -> List[List[dict]]:
    """The first `steps` batches of the epoch: per row the shot's index,
    the frame id, the label, the crop's row and column and the flip."""
    order = numpy_rng(seed, "shuffle", "train", epoch).permutation(
        np.arange(len(shots)))
    out = []
    for s in range(steps):
        rows = []
        for idx in order[s * batch_size:(s + 1) * batch_size]:
            shot = shots[int(idx)]
            frames = frames_of[shot]
            fi = int(numpy_rng(seed, "data", "train", epoch,
                               int(idx)).integers(0, len(frames)))
            aug = numpy_rng(seed, "aug", "train", epoch, int(idx), 0)
            ys = int(aug.integers(0, resize - crop + 1))
            xs = int(aug.integers(0, resize - crop + 1))
            flip = bool(aug.random() < 0.5)
            rows.append({"index": int(idx), "frame": frames[fi],
                         "label": labels[shot], "ys": ys, "xs": xs,
                         "flip": flip})
        out.append(rows)
    return out


def _taps(src: int, dst: int):
    o = np.arange(dst, dtype=np.float64)
    f = np.clip((o + 0.5) * src / dst - 0.5, 0, src - 1)
    i0 = np.floor(f).astype(np.int64)
    return i0, np.minimum(i0 + 1, src - 1), f - i0


def resize_frame(img: np.ndarray, size: int) -> np.ndarray:
    """(h, w, 3) -> (size, size, 3) float64, bilinear."""
    y0, y1, wy = _taps(img.shape[0], size)
    x0, x1, wx = _taps(img.shape[1], size)
    v = img.astype(np.float64)
    top = v[y0][:, x0] + (v[y0][:, x1] - v[y0][:, x0]) * wx[None, :, None]
    bot = v[y1][:, x0] + (v[y1][:, x1] - v[y1][:, x0]) * wx[None, :, None]
    return top + (bot - top) * wy[:, None, None]


def crop_flip(x: np.ndarray, row: dict, crop: int) -> np.ndarray:
    y = x[row["ys"]:row["ys"] + crop, row["xs"]:row["xs"] + crop]
    return y[:, ::-1] if row["flip"] else y


def pixels(frame: np.ndarray, row: dict, resize: int, crop: int
           ) -> np.ndarray:
    return crop_flip(resize_frame(frame, resize), row, crop)


def luma(rgb: np.ndarray) -> np.ndarray:
    return rgb @ LUMA


def heat(cam: np.ndarray, t: float) -> np.ndarray:
    x = (cam.astype(np.float64) + 1e-6) * t
    with np.errstate(over="ignore"):
        if not np.isfinite(np.exp(x.max())):
            return np.zeros_like(x)
    e = np.exp(x)
    return np.nan_to_num(e / max(e.max(), 1e-30), nan=0.0, posinf=1.0,
                         neginf=0.0)


def neighbours(frames: List[str], frame: str, k: int, mode: str
               ) -> List[str]:
    i = frames.index(frame)
    n = len(frames)
    left = frames[max(0, i - k):i]
    right = frames[min(i + 1, n - 1):min(i + k + 1, n)]
    out = list(left) if mode in ("before", "before-after") else []
    out.append(frame)
    if mode in ("after", "before-after"):
        out += right
    return out


def seed_cam(cams: Dict[str, np.ndarray], frames: List[str], row: dict,
             knn: int, mode: str, t: float, resize: int, crop: int
             ) -> np.ndarray:
    fused = None
    for f in (neighbours(frames, row["frame"], knn, mode) if knn > 0
              else [row["frame"]]):
        c = heat(cams[f], t) if (knn > 0 and t > 0) else cams[f].astype(
            np.float64)
        fused = c if fused is None else np.maximum(fused, c)
    mh = linear_matrix(fused.shape[0], resize, False)
    mw = linear_matrix(fused.shape[1], resize, False)
    return np.clip(crop_flip(mh @ fused @ mw.T, row, crop), 0.0, 1.0)


def otsu_skimage(x: np.ndarray) -> float:
    """skimage.filters.threshold_otsu(x, nbins=256); 0 for a constant x."""
    x = np.asarray(x, np.float64).ravel()
    if x.min() == x.max():
        return 0.0
    counts, edges = np.histogram(x, bins=256)
    centers = (edges[:-1] + edges[1:]) / 2.0
    counts = counts.astype(np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / w1
    m2 = (np.cumsum((counts * centers)[::-1]) / np.cumsum(counts[::-1]))[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[:-1][int(np.argmax(var12))])


def roi_all(cam: np.ndarray) -> np.ndarray:
    return (cam * 255.0 >= otsu_skimage(np.floor(cam * 255.0))).astype(
        np.int32)
