"""Change-based inference for video streams (port of
engine/temporal_reuse.py; the demo's --reuse_threshold).

A frame whose mean absolute difference from the last computed frame of
its video (raw pixels, [0, 255] units) is below the threshold skips the
model and reuses that frame's CAM.  Rows of one video inside a batch
chain: a computed row becomes the reference of the rows after it, and a
reused row takes the CAM of the last computed frame before it, never of
a later one in the same batch.  Approximate by design: the evaluator's
protocol recomputes every frame and never takes this path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class FrameReusePlanner:
    """threshold <= 0 computes every frame."""

    def __init__(self, threshold: float):
        self.threshold = float(threshold)
        self._last_raw: Dict[str, np.ndarray] = {}
        self._last_cam: Dict[str, np.ndarray] = {}
        self.n_computed = 0
        self.n_reused = 0

    def plan(self, video_ids: List[str], raws: np.ndarray
             ) -> Tuple[List[int], List[Optional[str]]]:
        """(compute_rows, reuse_from) of one ordered batch: the rows that
        need the model, and for each row the video whose cached CAM
        serves it (None for a computed row)."""
        compute_rows: List[int] = []
        reuse_from: List[Optional[str]] = [None] * len(video_ids)
        for i, (vid, raw) in enumerate(zip(video_ids, raws)):
            prev = self._last_raw.get(vid)
            if (self.threshold > 0.0 and prev is not None
                    and float(np.mean(np.abs(
                        raw.astype(np.float32)
                        - prev.astype(np.float32)))) < self.threshold):
                reuse_from[i] = vid
                self.n_reused += 1
            else:
                compute_rows.append(i)
                self._last_raw[vid] = np.asarray(raw)
                self.n_computed += 1
        return compute_rows, reuse_from

    def store_cam(self, vid: str, cam: np.ndarray) -> None:
        self._last_cam[vid] = np.asarray(cam)

    def cam_for(self, vid: str) -> np.ndarray:
        return self._last_cam[vid]

    @property
    def reuse_fraction(self) -> float:
        total = self.n_computed + self.n_reused
        return self.n_reused / total if total else 0.0

    def resolve_rows(self, video_ids: List[str],
                     compute_rows: List[int],
                     reuse_from: List[Optional[str]],
                     computed_cams: Optional[np.ndarray],
                     out: np.ndarray) -> None:
        """Fills out[i] for every row of a planned batch, rows in order;
        computed_cams[j] is the CAM of compute_rows[j]."""
        row_to_j = {row: j for j, row in enumerate(compute_rows)}
        for i, src in enumerate(reuse_from):
            if src is not None:
                out[i] = self.cam_for(src)
            else:
                out[i] = computed_cams[row_to_j[i]]
                self.store_cam(video_ids[i], out[i])
