"""Epoch batches of a WSOLVideoDataset on the step's device (port of
data/pipeline.py: shuffle, per-shard slices with tail padding, the
`valid` mask, clip-major batches and padding by tiling).

Each batch is a dict of tensors on `device` in the layout of
engine/steps.py (image and raw_img (B, c, c, 3), std_cam, roi and
msk_bbox (B, c, c), label, has_cam, seq_iter, frm_iter, fg_size and
valid (B,)) plus `image_id`, a list of frame ids.  The pixels come from
the device's image route: libjpeg on the host for a CPU device
(data/native_loader.py, bit-equal to the JAX package's native path),
nvJPEG on the card for a CUDA device (data/nvjpeg_loader.py).  The CAM
side stays host numpy with the image's crop and flip.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import native_loader, nvjpeg_loader
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset

_STACK_KEYS = ("image", "label", "raw_img", "std_cam", "has_cam",
               "seq_iter", "frm_iter", "roi", "msk_bbox", "fg_size")


def collate(items: List[dict]) -> Dict[str, np.ndarray]:
    """Stack sample dicts (clips flattened clip-major)."""
    batch: Dict[str, np.ndarray] = {}
    for k in _STACK_KEYS:
        batch[k] = np.stack([it[k] for it in items])
    batch["image_id"] = [it["image_id"] for it in items]
    return batch


def _take(v, idx: np.ndarray):
    if isinstance(v, torch.Tensor):
        return v[torch.from_numpy(idx).to(v.device)]
    return v[idx]


def pad_batch_by_tiling(batch: dict, target: int, clip_len: int = 1
                        ) -> dict:
    """Fill a short batch by repeating whole clips and mark the repeats
    invalid, so that metrics count every image once.  Entries are numpy
    arrays or tensors."""
    n = batch["label"].shape[0]
    if n % clip_len:
        raise ValueError(f"{n} frames are not whole clips of {clip_len}")
    n_clips = n // clip_len
    valid = np.zeros(target, bool)
    valid[:n] = True
    if n == target:
        batch = dict(batch)
        batch["valid"] = valid
        return batch
    reps = [i % n_clips for i in range(target // clip_len)]
    idx = np.concatenate([np.arange(r * clip_len, (r + 1) * clip_len)
                          for r in reps])
    out = {k: _take(batch[k], idx) for k in _STACK_KEYS}
    out["image_id"] = [batch["image_id"][i] for i in idx]
    out["valid"] = valid
    return out


class DataPipeline:
    """Iterate the epoch batches of a WSOLVideoDataset on `device`."""

    def __init__(self, dataset: WSOLVideoDataset, batch_size: int,
                 keychain: KeyChain, shuffle: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_remainder: bool = False, device="cuda"):
        self.ds = dataset
        self.batch_size = batch_size
        self.kc = keychain
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_remainder = drop_remainder
        self.device = torch.device(device)
        # host ms per batch of the last epoch: the pixels (decode, resize,
        # crop; on the card the host's part of it) and the CAM side
        self.timing: Dict[str, List[float]] = {"pixels_ms": [],
                                               "cams_ms": []}

    def _epoch_indices_valid(self, epoch: int,
                             subset: Optional[np.ndarray] = None):
        """(idxs, valid): this shard's sample indices, and a mask that is
        False on the tail duplicates of an unshuffled (eval) epoch.  Each
        shard sees ceil(n / shards) samples; train keeps the duplicates
        valid, so every shard takes the same number of steps."""
        order = (np.asarray(subset, np.int64) if subset is not None
                 else np.arange(len(self.ds)))
        n = len(order)
        if self.shuffle:
            rng = self.kc.numpy_rng("shuffle", self.ds.split, epoch)
            order = rng.permutation(order)
        per = -(-n // self.num_shards)
        padded = np.concatenate([order, order[:per * self.num_shards - n]])
        pos = np.arange(len(padded))
        valid = (pos < n) | self.shuffle
        return (padded[self.shard_index::self.num_shards],
                valid[self.shard_index::self.num_shards])

    def steps_per_epoch(self, subset: Optional[np.ndarray] = None) -> int:
        n = len(self._epoch_indices_valid(0, subset)[0])
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_pixels(self, paths, resize, crop, xs, ys, flips):
        if self.device.type == "cpu":
            norm, raw = native_loader.load_batch(
                paths, resize=resize, crop=crop, xs=np.asarray(xs),
                ys=np.asarray(ys), flips=np.asarray(flips))
            return torch.from_numpy(norm), torch.from_numpy(raw)
        return nvjpeg_loader.load_batch(paths, resize, crop, xs, ys, flips,
                                        self.device)

    def _epoch_native(self, epoch: int, idxs: np.ndarray,
                      shard_valid: np.ndarray,
                      target: int) -> Iterator[dict]:
        """Resolves each batch's frame ids and augmentation draws on the
        host (clip-major; each clip frame with its own draw), decodes the
        batch in one loader call and pairs each CAM with its image's
        crop and flip."""
        ds = self.ds
        c = ds.crop_size
        r = ds.transform.resize_size if ds.transform.train else c
        clip_len = ds.clip_len
        for s in range(0, len(idxs), self.batch_size):
            chunk = idxs[s:s + self.batch_size]
            if self.drop_remainder and len(chunk) < self.batch_size:
                return
            fids, labels, xs, ys, flips, seqs, frms = ([] for _ in range(7))
            for idx in chunk:
                ids = ds.sample_ids(int(idx))
                lab = ds.md.labels[ds.md.image_ids[int(idx)]]
                for fi, fid in enumerate(ids):
                    fids.append(fid)
                    labels.append(lab)
                    seqs.append(np.float32(idx))
                    frms.append(np.float32(fi))
                    if ds.transform.train:
                        rng = ds.kc.numpy_rng("aug", ds.split, epoch,
                                              int(idx), fi)
                        ys.append(int(rng.integers(0, r - c + 1)))
                        xs.append(int(rng.integers(0, r - c + 1)))
                        flips.append(int(rng.random()
                                         < ds.transform.hflip_p))
                    else:
                        ys.append(0)
                        xs.append(0)
                        flips.append(0)
            t0 = time.perf_counter()
            norm, raw = self._load_pixels(
                [f"{ds.data_root}/{f}" for f in fids], r, c, xs, ys, flips)
            t1 = time.perf_counter()
            n = len(fids)
            cams = np.zeros((n, c, c), np.float32)
            has = np.zeros((n,), np.float32)
            rois = np.zeros((n, c, c), np.int32)
            msks = np.ones((n, c, c), np.float32)
            fgs = np.zeros((n,), np.float32)
            if ds.cam_store is not None:
                for m, fid in enumerate(fids):
                    (cams[m], has[m], rois[m], msks[m],
                     fgs[m]) = ds.cam_roi_for(fid, ys[m], xs[m],
                                              bool(flips[m]))
            self.timing["pixels_ms"].append((t1 - t0) * 1e3)
            self.timing["cams_ms"].append((time.perf_counter() - t1) * 1e3)
            batch = {
                "image": norm,
                "label": np.asarray(labels, np.int32),
                "raw_img": raw,
                "std_cam": cams,
                "has_cam": has,
                "seq_iter": np.asarray(seqs, np.float32),
                "frm_iter": np.asarray(frms, np.float32),
                "roi": rois,
                "msk_bbox": msks,
                "fg_size": fgs,
                "image_id": fids,
            }
            out = pad_batch_by_tiling(batch, target, clip_len)
            out["valid"][:n] &= np.repeat(shard_valid[s:s + len(chunk)],
                                          clip_len)
            yield self._to_device(out)

    def _to_device(self, batch: dict) -> dict:
        """Host arrays go to the card from pinned memory, asynchronously:
        a copy from pageable memory would wait for the work already queued
        on the stream (the previous train step)."""
        out = {"image_id": batch["image_id"]}
        for k, v in batch.items():
            if k == "image_id":
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def epoch(self, epoch: int, subset: Optional[np.ndarray] = None
              ) -> Iterator[dict]:
        """Batches of batch_size clips (batch_size * clip_len frames,
        clip-major) on the pipeline's device."""
        self.ds.set_epoch(epoch)
        self.timing = {"pixels_ms": [], "cams_ms": []}
        idxs, shard_valid = self._epoch_indices_valid(epoch, subset)
        yield from self._epoch_native(epoch, idxs, shard_valid,
                                      self.batch_size * self.ds.clip_len)
