"""The card-resident train data plane (port of data/device_feed.py,
train_device_cache_mb).

The pixels and the stored CAMs of the train set do not change between
epochs; only the sampling does (frame per shot, crop, flip).  So they stay
on the pipeline's device:

- a frames pool (N, R, R, 3) uint8 holds every train frame at resize
  resolution, filled the first time a frame is sampled by the route's
  decode_resize_u8 (libjpeg on the host for a CPU device, nvJPEG on the
  card), so each frame is decoded once in the whole run;
- a CAM pool (N, h', w') float32 holds the stored stage-1 CAMs, and the
  stored thresholds (x 255, used only when sl_tc_knn == 0) stay beside it;
- each epoch uploads its sampling plan once (pool rows, crop offsets,
  flips, labels, CAM windows, thresholds: a few KB), and one assembly
  (make_assemble; the chunked runner of engine/scan_train.py calls it on
  plan rows, epoch_plan) a step gathers, crops and flips the pixels, heat-fuses the CAM window,
  resizes, crops, flips and clips the fused CAM and takes its ROI and
  foreground size, all on the device: the compact batch of
  h2d_transfer=uint8 (`raw_u8`; the train step derives the normalized
  input), with the CAM planes unpacked.

The sampling streams are the streamed pipeline's (KeyChain("aug", split,
epoch, index, frame): ys, then xs, then the flip), so turning the feed on
replays the same epochs; the pixels equal the decoded-frame cache's bit
for bit; the CAM side differs from the streamed route's host numpy by
float rounding (~1e-7), which can flip a pixel on a threshold.  The
feed is off for eval splits and over budget; the pipeline then streams,
and says so in its `data_route`.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.roi import roi_batch
from tcam_wsol_video_tpu_torch.cams.temporal import fuse_temporal_max
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import SpanClock
from tcam_wsol_video_tpu_torch.data import native_loader, nvjpeg_loader
from tcam_wsol_video_tpu_torch.data.transforms import crop_flip, to_device
from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear
from tcam_wsol_video_tpu_torch.ops.otsu import otsu_threshold_skimage255


def make_assemble(c: int, r: int, roi_method: str, p_min_area: float,
                  use_roi: bool, has_store: bool):
    """Returns assemble(frames_pool, cams_pool, rows, cam_rows, cam_valid,
    ys, xs, flips, t, threshs) -> the batch planes, on the pools' device:
    raw_u8 (B, c, c, 3) uint8, std_cam (B, c, c), has_cam (B,), roi
    (B, c, c) int32, msk_bbox (B, c, c), fg_size (B,).  rows (B,) and
    cam_rows (B, T) are int64 pool rows, cam_valid (B, T) bool, t the
    heat (0 = none), threshs (B,) stored thresholds in [0, 255] (< 0:
    Otsu's)."""

    def assemble(frames_pool, cams_pool, rows, cam_rows, cam_valid, ys, xs,
                 flips, t: float, threshs) -> Dict[str, torch.Tensor]:
        raw_u8 = crop_flip(frames_pool, c, ys, xs, flips, rows=rows)
        b = rows.shape[0]
        dev = frames_pool.device
        if not has_store:
            return {"raw_u8": raw_u8,
                    "std_cam": torch.zeros((b, c, c), device=dev),
                    "has_cam": torch.zeros((b,), device=dev),
                    "roi": torch.zeros((b, c, c), dtype=torch.int32,
                                       device=dev),
                    "msk_bbox": torch.ones((b, c, c), device=dev),
                    "fg_size": torch.zeros((b,), device=dev)}
        fused = fuse_temporal_max(cams_pool[cam_rows], cam_valid, t)
        fused = resize_bilinear(fused[..., None], (r, r),
                                align_corners=False)[..., 0]
        cam_t = crop_flip(fused, c, ys, xs, flips).clamp(0.0, 1.0)
        if use_roi:
            otsu = otsu_threshold_skimage255(torch.floor(cam_t * 255.0))
            th = torch.where(threshs >= 0.0, threshs, otsu)
            roi, msk, _ = roi_batch(cam_t, roi_method, p_min_area,
                                    threshs=th)
            use_fg = roi.sum((1, 2)) > 0
        else:
            roi = torch.zeros((b, c, c), dtype=torch.int32, device=dev)
            msk = torch.ones((b, c, c), device=dev)
            use_fg = torch.zeros((b,), dtype=torch.bool, device=dev)
        fg_roi = (cam_t * (roi > 0)).sum((1, 2)) / float(c * c)
        fg = torch.where(use_fg, fg_roi, cam_t.mean((1, 2)))
        return {"raw_u8": raw_u8, "std_cam": cam_t,
                "has_cam": torch.ones((b,), device=dev), "roi": roi,
                "msk_bbox": msk, "fg_size": fg}

    return assemble


class DeviceTrainFeed:
    """An epoch iterator of train batches assembled from pools on the
    pipeline's device.  Built by DataPipeline(train_device_cache_mb=...);
    `enabled` is False, and the pipeline streams, for an eval split or
    when the frames pool would exceed the budget."""

    def __init__(self, pipeline, budget_mb: int):
        self.pipe = pipeline
        self.ds = ds = pipeline.ds
        self.device = pipeline.device
        self.enabled = False
        if not ds.transform.train:
            return
        # the frame universe: every frame a sampler can touch
        if ds.mode == constants.DS_SHOTS:
            frames: List[str] = sorted(ds.frame_to_shot.keys())
        else:
            frames = list(ds.md.image_ids)
        self.r = ds.transform.resize_size
        self.c = ds.crop_size
        n = len(frames)
        if n * self.r * self.r * 3 > budget_mb * (1 << 20):
            return
        self.frames = frames
        self.row_of = {f: i for i, f in enumerate(frames)}
        self.resident = np.zeros(n, bool)
        # decodes of each frame over the run (1 at most by design)
        self.decodes = np.zeros(n, np.int64)
        self.frames_pool = torch.zeros((n, self.r, self.r, 3),
                                       dtype=torch.uint8, device=self.device)
        self.has_store = ds.cam_store is not None
        self.cams_pool = torch.zeros((1, 1, 1), device=self.device)
        self.threshs = np.full(n, -1.0, np.float32)
        if self.has_store:
            self.cams_pool = torch.from_numpy(np.stack(
                [ds.cam_store.load_cam(f) for f in frames]).astype(
                    np.float32)).to(self.device)
            stored = ds.cam_store.thresholds
            if ds.sl_tc_knn == 0 and stored is not None:
                for i, fid in enumerate(frames):
                    if fid in stored:
                        # the store keeps [0, 1]; the ROI takes [0, 255]
                        self.threshs[i] = stored[fid] * 255.0
        self.assemble = make_assemble(self.c, self.r, ds.roi_method,
                                      ds.p_min_area_roi, bool(ds.use_roi),
                                      self.has_store)
        self.timing: Dict[str, List[float]] = {}
        self.counts = {"pool_misses": 0, "pool_decodes": 0}
        self.enabled = True

    # ------------------------------------------------------- pool filling
    def _decode_resize_u8(self, fids: List[str]) -> torch.Tensor:
        """The frames at resize resolution, uint8, on the pool's device:
        libjpeg on the host for the CPU, nvJPEG on the card."""
        paths = [f"{self.ds.data_root}/{f}" for f in fids]
        if self.device.type == "cpu":
            return torch.from_numpy(native_loader.decode_resize_u8(paths,
                                                                   self.r))
        return nvjpeg_loader.decode_resize_u8(paths, self.r, self.device)

    def _ensure_resident(self, rows: np.ndarray) -> None:
        """Decode the frames of `rows` that are not in the pool yet.  On
        the card the decode runs on nvJPEG's side stream and the insert on
        the current stream, after the work that reads the pool."""
        missing = ~self.resident[rows]
        self.counts["pool_misses"] += int(missing.sum())
        miss = np.unique(rows[missing])
        if miss.size == 0:
            return
        frames = self._decode_resize_u8([self.frames[i] for i in miss])
        self.frames_pool[to_device(miss, self.device)] = frames
        self.resident[miss] = True
        self.decodes[miss] += 1
        self.counts["pool_decodes"] += int(miss.size)

    # ------------------------------------------------------------- epochs
    def _plan_epoch(self, epoch: int, subset: Optional[np.ndarray] = None):
        """The epoch's sampling plan on the host: per-step arrays of pool
        rows, crop offsets, flips, labels, CAM windows and thresholds,
        drawn from the streamed pipeline's KeyChain streams.  Returns
        (plan {name: (n_steps, target[, T]) array}, per-step frame ids,
        the heat t)."""
        ds, pipe = self.ds, self.pipe
        idxs, shard_valid = pipe._epoch_indices_valid(epoch, subset)
        clip_len = ds.clip_len
        target = pipe.batch_size * clip_len
        k = (ds.decay_temp.sl_tc_knn if ds.decay_temp is not None
             else ds.sl_tc_knn)
        t_cap = 2 * int(k) + 1
        t_heat = float(ds.decay_temp.t) if ds.decay_temp is not None else 0.0
        if ds.sl_tc_knn == 0:
            t_heat = 0.0          # heating only with a temporal window
        steps = []
        all_ids: List[List[str]] = []
        for s in range(0, len(idxs), pipe.batch_size):
            chunk = idxs[s:s + pipe.batch_size]
            if pipe.drop_remainder and len(chunk) < pipe.batch_size:
                break
            fids, labels, seqs, frms, ys, xs, flips = ([] for _ in range(7))
            for idx in chunk:
                ids = ds.sample_ids(int(idx))
                lab = ds.md.labels[ds.md.image_ids[int(idx)]]
                for fi, fid in enumerate(ids):
                    fids.append(fid)
                    labels.append(lab)
                    seqs.append(np.float32(idx))
                    frms.append(np.float32(fi))
                    rng = ds.kc.numpy_rng("aug", ds.split, epoch, int(idx),
                                          fi)
                    ys.append(int(rng.integers(0, self.r - self.c + 1)))
                    xs.append(int(rng.integers(0, self.r - self.c + 1)))
                    flips.append(bool(rng.random() < ds.transform.hflip_p))
            n = len(fids)
            valid = np.zeros(target, bool)
            valid[:n] = np.repeat(shard_valid[s:s + len(chunk)], clip_len)
            if n < target:
                # whole clips repeated, as pipeline.pad_batch_by_tiling
                n_clips = n // clip_len
                sel = [(i % n_clips) * clip_len + j
                       for i in range(target // clip_len)
                       for j in range(clip_len)]
                fids, labels, seqs, frms, ys, xs, flips = (
                    [v[i] for i in sel]
                    for v in (fids, labels, seqs, frms, ys, xs, flips))
            rows = np.asarray([self.row_of[f] for f in fids], np.int64)
            cam_rows = np.zeros((target, t_cap), np.int64)
            cam_valid = np.zeros((target, t_cap), bool)
            threshs = np.full(target, -1.0, np.float32)
            if self.has_store:
                for m, fid in enumerate(fids):
                    for w, wid in enumerate(
                            ds._temporal_frames(fid)[:t_cap]):
                        cam_rows[m, w] = self.row_of[wid]
                        cam_valid[m, w] = True
                threshs = self.threshs[rows]
            steps.append({
                "rows": rows, "cam_rows": cam_rows, "cam_valid": cam_valid,
                "ys": np.asarray(ys, np.int64), "xs": np.asarray(xs,
                                                                 np.int64),
                "flips": np.asarray(flips, bool), "threshs": threshs,
                "label": np.asarray(labels, np.int32),
                "seq_iter": np.asarray(seqs, np.float32),
                "frm_iter": np.asarray(frms, np.float32), "valid": valid})
            all_ids.append(fids)
        if not steps:
            return {}, [], t_heat
        plan = {key: np.stack([st[key] for st in steps]) for key in steps[0]}
        return plan, all_ids, t_heat

    def epoch_plan(self, epoch: int, subset: Optional[np.ndarray] = None):
        """The epoch's plan for the chunked runner (engine/scan_train.py),
        with every frame it touches made resident in one burst before the
        first dispatch (JAX DeviceTrainFeed.epoch_plan).  Returns (plan
        {name: (n_steps, target[, T]) host array}, per-step frame ids, the
        heat t); records the plan and pool-fill ms and the burst's misses
        (distinct frames) and decodes as the epoch's counts."""
        self.counts = {"pool_misses": 0, "pool_decodes": 0}
        self.timing = {"pixels_ms": [], "assembly_ms": []}
        self.ds.set_epoch(epoch)
        t0 = time.perf_counter()
        plan, all_ids, t_heat = self._plan_epoch(epoch, subset)
        self.timing["plan_ms"] = [(time.perf_counter() - t0) * 1e3]
        if all_ids:
            t0 = time.perf_counter()
            self._ensure_resident(np.unique(plan["rows"]))
            self.timing["fill_ms"] = [(time.perf_counter() - t0) * 1e3]
        return plan, all_ids, t_heat

    def epoch(self, epoch: int, subset: Optional[np.ndarray] = None
              ) -> Iterator[dict]:
        """The epoch's batches on the pools' device: the assembly's planes
        plus label, seq_iter, frm_iter, valid and image_id."""
        self.counts = {"pool_misses": 0, "pool_decodes": 0}
        self.timing = {"pixels_ms": [], "assembly_ms": []}
        clock = SpanClock(self.device)
        t0 = time.perf_counter()
        plan, all_ids, t_heat = self._plan_epoch(epoch, subset)
        if not all_ids:
            return
        dev = {k: to_device(v, self.device) for k, v in plan.items()}
        self.timing["plan_ms"] = [(time.perf_counter() - t0) * 1e3]
        for s in range(len(all_ids)):
            t0 = time.perf_counter()
            self._ensure_resident(plan["rows"][s])
            self.timing["pixels_ms"].append((time.perf_counter() - t0)
                                            * 1e3)
            begin = clock.start()
            batch = self.assemble(
                self.frames_pool, self.cams_pool, dev["rows"][s],
                dev["cam_rows"][s], dev["cam_valid"][s], dev["ys"][s],
                dev["xs"][s], dev["flips"][s], t_heat, dev["threshs"][s])
            clock.stop(begin)
            for key in ("label", "seq_iter", "frm_iter", "valid"):
                batch[key] = dev[key][s]
            batch["image_id"] = all_ids[s]
            yield batch
        self.timing["assembly_ms"] = clock.millis()
