"""Epoch batches of a WSOLVideoDataset on the step's device (port of
data/pipeline.py: shuffle, per-shard slices with tail padding, the
`valid` mask, clip-major batches and padding by tiling).

Each batch is a dict of tensors on `device` in the layout of
engine/steps.py (image and raw_img (B, c, c, 3), std_cam, roi and
msk_bbox (B, c, c), label, has_cam, seq_iter, frm_iter, fg_size and
valid (B,)) plus `image_id`, a list of frame ids.

One planner samples every epoch (`DataPipeline.plan_batches`): each
batch's frame ids, labels, crops and flips, the tiling that fills a short
batch with whole clips, and its valid mask.  The streamed route loads
each plan as it comes; the card-resident feed stacks its epoch's plans
(data/device_feed.py).  The pixels come from the device's image route
(data/image_route.py): libjpeg on the host for a CPU device, bit-equal to
the JAX package's native path, nvJPEG on the card for a CUDA device.  The
CAM planes take the image's crop and flip.  On a CUDA device a batch whose
stored CAMs share one shape crosses as its CAM windows (B, T, h, w) and
its planes are made there in one batched pass (`card_cam_planes`, the
card-resident feed's device_feed.assemble_cam_planes); on a CPU device,
or for a batch of stored CAMs of several shapes, the host makes them
frame by frame in numpy (WSOLVideoDataset.cam_roi_for, bit-equal to the
JAX package's host path).

The train data plane's three options (hparams h2d_transfer,
decode_cache_mb, train_device_cache_mb):
- compact (h2d_transfer=uint8): `compact_batch` packs each batch, raw_u8
  (B, c, c, 3) uint8 in place of image and raw_img, std_cam_u16 uint16,
  roi and msk_bbox uint8; the step unpacks it
  (engine/steps.expand_compact_batch).  On the card the pixels are
  rounded there and stay uint8; the host planes cross packed.
- decode_cache_mb: frames decoded at resize resolution, rounded to uint8,
  kept across epochs in an LRU (the image route's frame_cache: in host
  memory on the CPU, in device memory on the card).
- train_device_cache_mb: the card-resident train feed
  (data/device_feed.DeviceTrainFeed) serves the train epochs when the
  frames pool fits the budget; `data_route` says which route ran.

A streamed batch records the spans data.pixels (the decode, resize and
crop; on the card the host's part of it) and, over a CAM store, data.cams
(the CAM side: the stored CAMs read, then fused, resized, cropped and
their ROI taken on the host, or enqueued on the card) on
core/clock.TRACE, with the counter data.cams_card or data.cams_host of
the batch's frames by the route its CAM side took.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.device_feed import (DeviceTrainFeed,
                                                       assemble_cam_planes)
from tcam_wsol_video_tpu_torch.data.image_route import route_for
from tcam_wsol_video_tpu_torch.data.transforms import to_device

_STACK_KEYS = ("image", "label", "raw_img", "std_cam", "has_cam",
               "seq_iter", "frm_iter", "roi", "msk_bbox", "fg_size")
# the CAM planes of a batch, in cam_roi_for's order
_CAM_KEYS = ("std_cam", "has_cam", "roi", "msk_bbox", "fg_size")


def _take(v, idx: np.ndarray):
    if isinstance(v, torch.Tensor):
        return v[to_device(idx, v.device)]
    return v[idx]


def tiling_index(n: int, target: int, clip_len: int = 1
                 ) -> Optional[np.ndarray]:
    """The rows of a batch of n frames that fill it to target frames by
    repeating whole clips, in order; None when it is full."""
    if n % clip_len:
        raise ValueError(f"{n} frames are not whole clips of {clip_len}")
    if n == target:
        return None
    clips = np.arange(target // clip_len) % (n // clip_len)
    return (clips[:, None] * clip_len + np.arange(clip_len)).ravel()


def pad_batch_by_tiling(batch: dict, target: int, clip_len: int = 1
                        ) -> dict:
    """Fill a short batch by repeating whole clips (tiling_index) and mark
    the repeats invalid, so that metrics count every image once.  Entries
    are numpy arrays or tensors."""
    n = batch["label"].shape[0]
    idx = tiling_index(n, target, clip_len)
    valid = np.zeros(target, bool)
    valid[:n] = True
    if idx is None:
        out = dict(batch)
    else:
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
    the packed ones come back as tensors on their device.  CAM planes
    made on a card cross nothing, so they stay as they are, as the
    card-resident feed's."""
    out = dict(batch)
    out.pop("image", None)
    raw = torch.as_tensor(out.pop("raw_img"))
    out["raw_u8"] = torch.round(raw).clamp_(0.0, 255.0).to(torch.uint8)
    if "std_cam" in out and not _on_card(out["std_cam"]):
        cam = torch.as_tensor(out.pop("std_cam"))
        out["std_cam_u16"] = torch.round(cam.clamp(0.0, 1.0) * 65535.0).to(
            torch.uint16)
    for k in ("roi", "msk_bbox"):
        if k in out and not _on_card(out[k]):
            out[k] = torch.as_tensor(out[k]).to(torch.uint8)
    return out


def _on_card(v) -> bool:
    return isinstance(v, torch.Tensor) and v.device.type != "cpu"


def card_cam_planes(ds: WSOLVideoDataset, fids: List[str], ys, xs, flips,
                    r: int, device: torch.device
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The CAM planes of the frames `fids` under their crops (ys, xs) of
    the (r, r) resize and flips, made on `device` from their stored CAM
    windows (the feed's plan layout: (B, T) windows of ds.cam_window,
    T = ds.cam_window_len()) by
    device_feed.assemble_cam_planes, as cam_roi_for's planes.  The host
    reads the windows and sends them with the draws and thresholds in
    pinned, non-blocking copies, and syncs nothing.  None when the
    stored CAMs differ in shape."""
    t_cap = ds.cam_window_len()
    wins = [ds.cam_window(fid) for fid in fids]
    cams = {f: ds.cam_store.load_cam(f) for win in wins for f in win}
    if len({cam.shape for cam in cams.values()}) != 1:
        return None
    h, w = next(iter(cams.values())).shape
    windows = np.zeros((len(fids), t_cap, h, w), np.float32)
    valid = np.zeros((len(fids), t_cap), bool)
    for m, win in enumerate(wins):
        for k, f in enumerate(win):
            windows[m, k] = cams[f]
            valid[m, k] = True
    draws = to_device(np.asarray([ys, xs, flips], np.int64), device)
    return assemble_cam_planes(
        to_device(windows, device), to_device(valid, device), draws[0],
        draws[1], draws[2], ds.cam_heat(),
        to_device(ds.stored_threshs_255(fids), device), ds.crop_size, r,
        ds.roi_method, ds.p_min_area_roi, bool(ds.use_roi))


def _empty_cam_planes(n: int, c: int) -> Dict[str, np.ndarray]:
    """The planes of n frames without a stored CAM."""
    return {"std_cam": np.zeros((n, c, c), np.float32),
            "has_cam": np.zeros((n,), np.float32),
            "roi": np.zeros((n, c, c), np.int32),
            "msk_bbox": np.ones((n, c, c), np.float32),
            "fg_size": np.zeros((n,), np.float32)}


def host_cam_planes(ds: WSOLVideoDataset, fids: List[str], ys, xs, flips
                    ) -> Dict[str, np.ndarray]:
    """The same planes made frame by frame in host numpy
    (WSOLVideoDataset.cam_roi_for)."""
    planes = _empty_cam_planes(len(fids), ds.crop_size)
    for m, fid in enumerate(fids):
        for key, v in zip(_CAM_KEYS, ds.cam_roi_for(fid, ys[m], xs[m],
                                                    bool(flips[m]))):
            planes[key][m] = v
    return planes


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
        self.codec = route_for(self.device)
        self._decode_cache = (
            self.codec.frame_cache(decode_cache_mb, self.device)
            if decode_cache_mb > 0 else None)
        self.device_feed = None
        if train_device_cache_mb > 0:
            feed = DeviceTrainFeed(self, train_device_cache_mb)
            self.device_feed = feed if feed.enabled else None
        self._cache_seen = (0, 0)

    @property
    def data_route(self) -> str:
        """'device_feed' when the card-resident feed serves the epochs,
        else 'stream'."""
        return "stream" if self.device_feed is None else "device_feed"

    def epoch_stats(self) -> dict:
        """The data plane since the last call: its route and the
        decoded-frame cache's hits and misses."""
        cache = self._decode_cache
        hits, misses = ((cache.hits, cache.misses) if cache is not None
                        else (0, 0))
        out = {"data_route": self.data_route,
               "cache_hits": hits - self._cache_seen[0],
               "cache_misses": misses - self._cache_seen[1]}
        self._cache_seen = (hits, misses)
        return out

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

    def plan_batches(self, epoch: int, subset: Optional[np.ndarray] = None
                     ) -> Iterator[dict]:
        """The epoch's sampling, one batch's host plan a step (the dataset
        set to the epoch): its n real frames clip-major, each clip frame
        with its own draws.  A plan holds ids (the frame ids), label (n,)
        int32, seq_iter and frm_iter (n,) float32, ys and xs (n,) int64
        and flips (n,) bool (KeyChain("aug", split, epoch, index, frame):
        ys, then xs, then the flip; zeros on an eval split), tile (the
        tiling_index that fills the batch with whole clips, None when it
        is full) and valid (batch_size * clip_len,) bool."""
        ds = self.ds
        c = ds.crop_size
        train = ds.transform.train
        r = ds.transform.resize_size if train else c
        clip_len = ds.clip_len
        target = self.batch_size * clip_len
        idxs, shard_valid = self._epoch_indices_valid(epoch, subset)
        for s in range(0, len(idxs), self.batch_size):
            chunk = idxs[s:s + self.batch_size]
            if self.drop_remainder and len(chunk) < self.batch_size:
                return
            ids, labels, seqs, frms, draws = [], [], [], [], []
            for idx in chunk:
                idx = int(idx)
                clip = ds.sample_ids(idx)
                ids += clip
                labels += [ds.md.labels[ds.md.image_ids[idx]]] * len(clip)
                seqs += [idx] * len(clip)
                frms += range(len(clip))
                if train:
                    for fi in range(len(clip)):
                        rng = ds.kc.numpy_rng("aug", ds.split, epoch, idx, fi)
                        draws.append((rng.integers(0, r - c + 1),
                                      rng.integers(0, r - c + 1),
                                      rng.random() < ds.transform.hflip_p))
            n = len(ids)
            ys, xs, flips = (np.asarray(draws, np.int64).T.copy() if train
                             else np.zeros((3, n), np.int64))
            valid = np.zeros(target, bool)
            valid[:n] = np.repeat(shard_valid[s:s + len(chunk)], clip_len)
            yield {"ids": ids, "label": np.asarray(labels, np.int32),
                   "seq_iter": np.asarray(seqs, np.float32),
                   "frm_iter": np.asarray(frms, np.float32), "ys": ys,
                   "xs": xs, "flips": flips.astype(bool),
                   "tile": tiling_index(n, target, clip_len),
                   "valid": valid}

    def load_pixels(self, paths: List[str], resize: int, crop: int, xs, ys,
                    flips):
        """(normalized, raw) (N, crop, crop, 3) float32 on the pipeline's
        device from its image route, through the decoded-frame cache when
        it is on."""
        if self._decode_cache is not None:
            return self._decode_cache.load_batch(paths, resize, crop, xs,
                                                 ys, flips)
        return self.codec.load_batch(paths, resize, crop, xs, ys, flips,
                                     self.device)

    def _cam_planes(self, fids: List[str], ys, xs, flips, r: int) -> dict:
        """A streamed batch's CAM planes: on the card from the stored CAM
        windows when the device is a card and the batch's stored CAMs
        share one shape, else frame by frame on the host."""
        planes = None
        if self.device.type == "cuda":
            planes = card_cam_planes(self.ds, fids, ys, xs, flips, r,
                                     self.device)
        if planes is not None:
            TRACE.count("data.cams_card", len(fids))
            return planes
        TRACE.count("data.cams_host", len(fids))
        return host_cam_planes(self.ds, fids, ys, xs, flips)

    def _stream(self, epoch: int, subset: Optional[np.ndarray]
                ) -> Iterator[dict]:
        """Loads each plan as it is drawn: the batch's real frames decoded
        in one image-route call, each CAM paired with its image's crop and
        flip, then the clips tiled into a short batch."""
        ds = self.ds
        c = ds.crop_size
        r = ds.transform.resize_size if ds.transform.train else c
        target = self.batch_size * ds.clip_len
        for plan in self.plan_batches(epoch, subset):
            fids, ys, xs, flips = (plan[k] for k in ("ids", "ys", "xs",
                                                    "flips"))
            with TRACE.span("data.pixels"):
                norm, raw = self.load_pixels(
                    [f"{ds.data_root}/{f}" for f in fids], r, c, xs, ys,
                    flips)
            if ds.cam_store is None:
                # no CAM side: the empty planes are the wait's own time
                planes = _empty_cam_planes(len(fids), c)
            else:
                with TRACE.span("data.cams"):
                    planes = self._cam_planes(fids, ys, xs, flips, r)
            batch = {"image": norm, "label": plan["label"], "raw_img": raw,
                     "std_cam": planes["std_cam"],
                     "has_cam": planes["has_cam"],
                     "seq_iter": plan["seq_iter"],
                     "frm_iter": plan["frm_iter"], "roi": planes["roi"],
                     "msk_bbox": planes["msk_bbox"],
                     "fg_size": planes["fg_size"], "image_id": fids}
            out = pad_batch_by_tiling(batch, target, ds.clip_len)
            out["valid"] = plan["valid"]
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
        if self.device_feed is not None:
            yield from self.device_feed.epoch(epoch, subset)
            return
        yield from self._stream(epoch, subset)
