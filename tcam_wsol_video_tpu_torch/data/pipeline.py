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

The train data plane's three options (hparams h2d_transfer,
decode_cache_mb, train_device_cache_mb):
- compact (h2d_transfer=uint8): `compact_batch` packs each batch, raw_u8
  (B, c, c, 3) uint8 in place of image and raw_img, std_cam_u16 uint16,
  roi and msk_bbox uint8; the step unpacks it
  (engine/steps.expand_compact_batch).  On the card the pixels are
  rounded there and stay uint8; the host planes cross packed.
- decode_cache_mb: frames decoded at resize resolution, rounded to uint8,
  kept across epochs in an LRU (native_loader.DecodedFrameCache on the
  host, nvjpeg_loader.DeviceFrameCache on the card).
- train_device_cache_mb: the card-resident train feed
  (data/device_feed.DeviceTrainFeed) serves the train epochs when the
  frames pool fits the budget; `data_route` says which route ran.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import native_loader, nvjpeg_loader
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.device_feed import DeviceTrainFeed
from tcam_wsol_video_tpu_torch.data.transforms import to_device

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


def compact_batch(batch: dict) -> dict:
    """Pack a batch for h2d_transfer=uint8 (port of pipeline.compact_batch):
    image is dropped (the step derives it from the pixels), raw_img
    becomes raw_u8 (rounded half to even and clipped to [0, 255], uint8),
    std_cam becomes std_cam_u16 (round(clip(cam, 0, 1) * 65535), uint16),
    roi and msk_bbox become uint8.  Entries are numpy arrays or tensors;
    the packed ones come back as tensors on their device."""
    out = dict(batch)
    out.pop("image", None)
    raw = torch.as_tensor(out.pop("raw_img"))
    out["raw_u8"] = torch.round(raw).clamp_(0.0, 255.0).to(torch.uint8)
    if "std_cam" in out:
        cam = torch.as_tensor(out.pop("std_cam"))
        out["std_cam_u16"] = torch.round(cam.clamp(0.0, 1.0) * 65535.0).to(
            torch.uint16)
    for k in ("roi", "msk_bbox"):
        if k in out:
            out[k] = torch.as_tensor(out[k]).to(torch.uint8)
    return out


class DataPipeline:
    """Iterate the epoch batches of a WSOLVideoDataset on `device`."""

    def __init__(self, dataset: WSOLVideoDataset, batch_size: int,
                 keychain: KeyChain, shuffle: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_remainder: bool = False, compact: bool = False,
                 decode_cache_mb: int = 0, train_device_cache_mb: int = 0,
                 device="cuda"):
        self.ds = dataset
        self.batch_size = batch_size
        self.kc = keychain
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_remainder = drop_remainder
        self.device = torch.device(device)
        self.compact = compact
        self._decode_cache = None
        if decode_cache_mb > 0:
            self._decode_cache = (
                native_loader.DecodedFrameCache(decode_cache_mb)
                if self.device.type == "cpu"
                else nvjpeg_loader.DeviceFrameCache(decode_cache_mb,
                                                    self.device))
        self._device_feed = None
        if train_device_cache_mb > 0:
            feed = DeviceTrainFeed(self, train_device_cache_mb)
            self._device_feed = feed if feed.enabled else None
        # ms per batch of the last epoch: the host's pixel work (decode,
        # resize, crop; on the card the host's part of it; the feed's pool
        # fill), the host CAM side, and the feed's assembly on the device
        self.timing: Dict[str, List[float]] = {}
        self._cache_seen = (0, 0)

    @property
    def data_route(self) -> str:
        """'device_feed' when the card-resident feed serves the epochs,
        else 'stream'."""
        return "stream" if self._device_feed is None else "device_feed"

    def epoch_stats(self) -> dict:
        """The last epoch's data plane: its route, the mean ms per batch
        of each `timing` entry (data_<name>_per_step), the feed's plan ms
        (data_plan_ms, once an epoch) and, for the chunked runner, its
        pool fill before the first dispatch (data_fill_ms), the decoded-frame
        cache's hits and misses in the epoch and the feed's pool misses
        (frames not resident when their step came) and decodes."""
        feed = self._device_feed
        timing = {"pixels_ms": [], "cams_ms": [], "assembly_ms": [],
                  **(feed.timing if feed is not None else self.timing)}
        once = ("plan_ms", "fill_ms")
        out = {"data_route": self.data_route,
               **{f"data_{k}_per_step": float(np.mean(v)) if v else 0.0
                  for k, v in timing.items() if k not in once},
               **{f"data_{k}": float(sum(timing.get(k, [])))
                  for k in once}}
        cache = self._decode_cache
        hits, misses = ((cache.hits, cache.misses) if cache is not None
                        else (0, 0))
        out["cache_hits"] = hits - self._cache_seen[0]
        out["cache_misses"] = misses - self._cache_seen[1]
        self._cache_seen = (hits, misses)
        counts = (feed.counts if feed is not None
                  else {"pool_misses": 0, "pool_decodes": 0})
        return {**out, **counts}

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
            load = (native_loader.load_batch if self._decode_cache is None
                    else self._decode_cache.load_batch)
            norm, raw = load(paths, resize=resize, crop=crop,
                             xs=np.asarray(xs), ys=np.asarray(ys),
                             flips=np.asarray(flips))
            return torch.from_numpy(norm), torch.from_numpy(raw)
        if self._decode_cache is not None:
            return self._decode_cache.load_batch(paths, resize, crop, xs,
                                                 ys, flips)
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
            if self.compact:
                out = compact_batch(out)
            yield self._to_device(out)

    def _to_device(self, batch: dict) -> dict:
        """Host arrays go to the card from pinned memory, asynchronously:
        a copy from pageable memory would wait for the work already queued
        on the stream (the previous train step)."""
        return {k: v if k == "image_id" else to_device(v, self.device)
                for k, v in batch.items()}

    def epoch(self, epoch: int, subset: Optional[np.ndarray] = None
              ) -> Iterator[dict]:
        """Batches of batch_size clips (batch_size * clip_len frames,
        clip-major) on the pipeline's device: from the card-resident feed
        when it is on, else streamed (packed when compact)."""
        self.ds.set_epoch(epoch)
        if self._device_feed is not None:
            yield from self._device_feed.epoch(epoch, subset)
            return
        self.timing = {"pixels_ms": [], "cams_ms": []}
        idxs, shard_valid = self._epoch_indices_valid(epoch, subset)
        yield from self._epoch_native(epoch, idxs, shard_valid,
                                      self.batch_size * self.ds.clip_len)
