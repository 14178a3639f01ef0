"""WSOL video dataset: shots, frames, temporal neighbours, CAM fusion and
ROI (port of data/dataset.py, without the PIL image path).

- Train ids are shot directories; each epoch draws one frame per shot
  (or a clip of 2 knn_tc + 1 frames) from KeyChain streams that match the
  JAX package's bit for bit.
- The seed CAM of a frame fuses the stored CAMs of its +-sl_tc_knn
  neighbours, heated with exp(cam t) / max, by elementwise max.
- The CAM takes the image's crop and flip, and its ROI comes from a stored
  threshold or, after heating, from Otsu.
The pixels are decoded by the pipeline's image loader (data/pipeline.py).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.folds import (SplitMetadata,
                                                  resized_gt_boxes)
from tcam_wsol_video_tpu_torch.data.transforms import (PairedTransform,
                                                       _resize_cam)


def heat_cam_np(cam: np.ndarray, t: float) -> np.ndarray:
    """exp((cam + 1e-6) t) / max with nan/posinf guards.  When the peak
    would overflow every pixel maps to 0 (inf / inf -> nan -> 0 and
    finite / inf -> 0 in the reference's form); only the scalar peak is
    checked, so the array exp never overflows."""
    x = (cam + 1e-6) * t
    with np.errstate(over="ignore"):
        peak = np.exp(x.max())
    if not np.isfinite(peak):
        return np.zeros_like(cam)
    e = np.exp(x)
    e = e / max(e.max(), 1e-30)
    return np.nan_to_num(e, nan=0.0, posinf=1.0, neginf=0.0)


class WSOLVideoDataset:
    def __init__(self,
                 metadata: SplitMetadata,
                 data_root: str,
                 split: str,
                 dataset_name: str,
                 transform: PairedTransform,
                 keychain: KeyChain,
                 crop_size: int = constants.CROP_SIZE,
                 cam_store: Optional[CamStore] = None,
                 knn_tc: int = 0,
                 sl_tc_knn: int = 0,
                 sl_tc_knn_mode: str = constants.TIME_INSTANT,
                 decay_temp: Optional[DecayTemp] = None,
                 use_roi: bool = False,
                 roi_method: str = constants.ROI_ALL,
                 p_min_area_roi: float = 0.05):
        self.md = metadata
        self.data_root = data_root
        self.split = split
        self.dataset_name = dataset_name
        self.transform = transform
        self.kc = keychain
        self.crop_size = crop_size
        self.cam_store = cam_store
        self.knn_tc = knn_tc
        self.sl_tc_knn = sl_tc_knn
        self.sl_tc_knn_mode = sl_tc_knn_mode
        self.decay_temp = decay_temp
        self.use_roi = use_roi
        self.roi_method = roi_method
        self.p_min_area_roi = p_min_area_roi
        self.epoch = 0

        self.mode = self._detect_mode()
        self.index_of_frames: Dict[str, List[str]] = {}
        self.frame_to_shot: Dict[str, str] = {}
        if self.mode == constants.DS_SHOTS:
            self._index_frames()

    def _detect_mode(self) -> str:
        if self.dataset_name not in constants.VIDEO_DATASETS:
            return constants.DS_FRAMES
        first = os.path.join(self.data_root, self.md.image_ids[0])
        if os.path.isdir(first):
            return constants.DS_SHOTS
        if os.path.isfile(first):
            return constants.DS_FRAMES
        raise FileNotFoundError(
            f"dataset id {self.md.image_ids[0]!r} resolves to neither a "
            f"shot dir nor a frame under {self.data_root!r}")

    def _index_frames(self) -> None:
        for shot in self.md.image_ids:
            frames = sorted(f for f in os.listdir(
                os.path.join(self.data_root, shot)) if f.endswith(".jpg"))
            if not frames:
                raise FileNotFoundError(f"empty shot {shot}")
            rel = [f"{shot}/{f}" for f in frames]
            self.index_of_frames[shot] = rel
            for fr in rel:
                self.frame_to_shot[fr] = shot

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if self.decay_temp is not None:
            self.decay_temp.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.md.image_ids)

    @property
    def clip_len(self) -> int:
        return 2 * self.knn_tc + 1 if self.knn_tc > 0 else 1

    # --------------------------------------------------------- neighbours
    @staticmethod
    def _neighbors(frames: List[str], frame: str, k: int):
        i = frames.index(frame)
        n = len(frames)
        left = frames[max(0, i - k):i]
        right = frames[min(i + 1, n - 1):min(i + k + 1, n)]
        return left, right

    def _temporal_frames(self, frame_id: str) -> List[str]:
        """Frames whose stored CAMs fuse into this frame's seed CAM."""
        k = self.sl_tc_knn
        mode = self.sl_tc_knn_mode
        if self.decay_temp is not None:
            mode = self.decay_temp.sl_tc_knn_mode
            k = self.decay_temp.sl_tc_knn
        if self.mode != constants.DS_SHOTS or k == 0:
            return [frame_id]
        shot = self.frame_to_shot[frame_id]
        left, right = self._neighbors(self.index_of_frames[shot], frame_id,
                                      k)
        out = []
        if mode in (constants.TIME_BEFORE, constants.TIME_BEFORE_AFTER):
            out += left
        out.append(frame_id)
        if mode in (constants.TIME_AFTER, constants.TIME_BEFORE_AFTER):
            out += right
        return out

    # ------------------------------------------------------------- items
    def sample_ids(self, idx: int) -> List[str]:
        """Dataset index -> this epoch's frame id(s): a random frame per
        shot, or a clip of exactly 2 knn_tc + 1 frames (the anchor clamped
        into the shot; a short shot repeats its last frame)."""
        image_id = self.md.image_ids[idx]
        if self.mode != constants.DS_SHOTS:
            return [image_id]
        frames = self.index_of_frames[image_id]
        rng = self.kc.numpy_rng("data", self.split, self.epoch, idx)
        n = len(frames)
        if self.knn_tc == 0:
            return [frames[int(rng.integers(0, n))]]
        k = self.knn_tc
        clip_len = 2 * k + 1
        if n >= clip_len:
            a = int(rng.integers(k, n - k))
            return frames[a - k:a + k + 1]
        window = list(frames)
        while len(window) < clip_len:
            window.append(frames[-1])
        return window

    def _fused_cam(self, frame_id: str) -> Optional[np.ndarray]:
        if self.cam_store is None:
            return None
        t = self.decay_temp.t if self.decay_temp is not None else 0.0
        heated = self.sl_tc_knn > 0 and t > 0
        fused = None
        for fid in self._temporal_frames(frame_id):
            c = self.cam_store.load_cam(fid)
            if heated:
                c = heat_cam_np(c, t)
            fused = c if fused is None else np.maximum(fused, c)
        return fused

    def cam_roi_for(self, frame_id: str, i: int, j: int, flip: bool):
        """The fused CAM under the image's crop (row i, column j) and
        flip, and its ROI.  Returns (std_cam (c, c), has_cam, roi (c, c),
        msk_bbox (c, c), fg_size)."""
        c = self.crop_size
        cam = self._fused_cam(frame_id)
        roi = np.zeros((c, c), np.int64)
        msk_bbox = np.ones((c, c), np.float32)
        if cam is None:
            return (np.zeros((c, c), np.float32), np.float32(0.0),
                    roi.astype(np.int32), msk_bbox, np.float32(0.0))
        if self.transform.train:
            r = self.transform.resize_size
            cam_t = _resize_cam(cam, (r, r))[i:i + c, j:j + c]
            if flip:
                cam_t = cam_t[:, ::-1]
        else:
            cam_t = _resize_cam(cam, (c, c))
        cam_t = np.clip(np.ascontiguousarray(cam_t), 0.0, 1.0)
        if self.use_roi:
            th = None
            # a stored threshold is invalid after temporal heating: then
            # the ROI re-thresholds with Otsu
            if self.sl_tc_knn == 0 and self.cam_store is not None:
                stored = self.cam_store.thresholds
                if stored is not None and frame_id in stored:
                    # the store keeps [0, 1]; the ROI takes [0, 255]
                    th = stored[frame_id] * 255.0
            roi, msk_bbox, _ = roi_one_cam_np(
                cam_t, self.roi_method, self.p_min_area_roi, thresh=th)
        if self.use_roi and roi.sum() > 0:
            fg_size = np.float32((cam_t * (roi > 0)).sum() / (c * c))
        else:
            fg_size = np.float32(cam_t.mean())
        return (cam_t.astype(np.float32), np.float32(1.0),
                roi.astype(np.int32), np.asarray(msk_bbox, np.float32),
                fg_size)

    def eval_gt_boxes(self, image_id: str) -> np.ndarray:
        return resized_gt_boxes(self.md, image_id, self.crop_size)
