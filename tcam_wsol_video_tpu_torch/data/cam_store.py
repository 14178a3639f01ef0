"""Per-frame CAM store read by stage-2 training (port of
data/cam_store.py): one float32 .npy per frame under the frame id's path,
and `roi_thresholds.txt` with `id,threshold` lines, threshold in [0, 1].

A streamed epoch reads a few stored CAMs a frame, so `load_cam` keeps a
file's system calls to open, read and close, and parses each distinct
.npy header once (a store's CAMs share one): np.load's further calls and
its parse (`ast` over the header's dict) cost more than the read of a
28 x 28 CAM, about twice as long in all on the H100's host.
"""
from __future__ import annotations

import io
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

_NPY_MAGIC = b"\x93NUMPY"


def _npy_data_offset(raw: bytes) -> int:
    """Where the data of .npy bytes starts (format 1: a 2-byte header
    length after the magic and version; 2 and 3: 4 bytes); 0 when the
    bytes are no .npy."""
    if raw[:6] != _NPY_MAGIC or len(raw) < 12:
        return 0
    if raw[6] == 1:
        return 10 + int.from_bytes(raw[8:10], "little")
    return 12 + int.from_bytes(raw[8:12], "little")


def _read_file(path: str) -> bytes:
    fd = os.open(path, os.O_RDONLY)
    try:
        parts = []
        while True:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                return b"".join(parts)
            parts.append(chunk)
    finally:
        os.close(fd)


class CamStore:
    def __init__(self, root: str):
        self.root = root
        self._thresholds: Optional[Dict[str, float]] = None
        # header bytes -> (dtype, shape, order) of the arrays they start
        self._layouts: Dict[bytes, Tuple[np.dtype, tuple, str]] = {}

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
        """The frame's stored CAM, the array np.load reads."""
        raw = _read_file(os.path.join(self.root, image_id + ".npy"))
        offset = _npy_data_offset(raw)
        layout = self._layouts.get(raw[:offset]) if offset else None
        if layout is None:
            cam = np.load(io.BytesIO(raw))
            if offset:
                self._layouts[raw[:offset]] = (
                    cam.dtype, cam.shape, "F" if np.isfortran(cam) else "C")
        else:
            dtype, shape, order = layout
            cam = np.frombuffer(raw, dtype, count=math.prod(shape),
                                offset=offset).reshape(shape, order=order)
            cam = cam.copy(order="K")
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
