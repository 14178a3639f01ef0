"""Per-frame CAM store read by stage-2 training (port of
data/cam_store.py): one float32 .npy per frame under the frame id's path,
and `roi_thresholds.txt` with `id,threshold` lines, threshold in [0, 1].
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class CamStore:
    def __init__(self, root: str):
        self.root = root
        self._thresholds: Optional[Dict[str, float]] = None

    def save_cam(self, image_id: str, cam: np.ndarray) -> None:
        path = os.path.join(self.root, image_id + ".npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, cam.astype(np.float32))

    def save_thresholds(self, thresholds: Dict[str, float]) -> None:
        os.makedirs(self.root, exist_ok=True)
        with open(os.path.join(self.root, "roi_thresholds.txt"), "w") as f:
            for iid, th in thresholds.items():
                f.write(f"{iid},{th}\n")
        self._thresholds = None

    def has(self, image_id: str) -> bool:
        return os.path.isfile(os.path.join(self.root, image_id + ".npy"))

    def load_cam(self, image_id: str) -> np.ndarray:
        cam = np.load(os.path.join(self.root, image_id + ".npy"))
        if cam.ndim != 2:
            raise ValueError(f"CAM of {image_id} has shape {cam.shape}")
        return cam

    @property
    def thresholds(self) -> Optional[Dict[str, float]]:
        """The stored thresholds, None when the store has no file."""
        if self._thresholds is None:
            path = os.path.join(self.root, "roi_thresholds.txt")
            if not os.path.isfile(path):
                return None
            out: Dict[str, float] = {}
            with open(path) as f:
                for ln in f:
                    ln = ln.strip()
                    if ln:
                        iid, th = ln.rsplit(",", 1)
                        out[iid] = float(th)
            self._thresholds = out
        return self._thresholds
