"""The card-resident train data plane (port of data/device_feed.py,
train_device_cache_mb).

The pixels and the stored CAMs of the train set do not change between
epochs; only the sampling does (frame per shot, crop, flip).  So they stay
on the pipeline's device:

- a frames pool (N, R, R, 3) uint8 holds every train frame at resize
  resolution, filled the first time a frame is sampled by the image
  route's decode_resize_u8 (data/image_route.py: libjpeg on the host for
  a CPU device, nvJPEG on the card), so each frame is decoded once in the
  whole run;
- a CAM pool (N, h', w') float32 holds the stored stage-1 CAMs, and the
  stored thresholds (x 255, used only when sl_tc_knn == 0) stay beside it;
- each epoch uploads its sampling plan once (pool rows, crop offsets,
  flips, labels, CAM windows, thresholds: a few KB), and one assembly
  (make_assemble; the chunked runner of engine/scan_train.py calls it on
  plan rows, epoch_plan) a step gathers, crops and flips the pixels and
  makes the CAM planes (assemble_cam_planes: heat-fuses the CAM window,
  resizes, crops, flips and clips the fused CAM and takes its ROI and
  foreground size), all on the device: the compact batch of
  h2d_transfer=uint8 (`raw_u8`; the train step derives the normalized
  input), with the CAM planes unpacked.

The epoch's sampling is the streamed pipeline's own plan
(DataPipeline.plan_batches), so turning the feed on replays the same
epochs; the pixels equal the decoded-frame cache's bit for bit.  On a
CUDA device the streamed route makes its CAM planes with the same
assemble_cam_planes; on a CPU device it keeps the host numpy of
WSOLVideoDataset.cam_roi_for, from which the feed's differs by float
rounding (~1e-7), which can flip a pixel on a threshold.  The feed is
off for eval splits and over budget; the pipeline then streams, and says
so in its `data_route`.

On core/clock.TRACE the feed records the spans feed.plan (the sampling
plan), feed.fill (epoch_plan's burst of decodes), data.pixels (a
per-step epoch's decodes before each batch) and feed.assemble (a
per-step epoch's assembly), and the counters feed.frames (the distinct
frames an epoch samples), feed.misses (sampled frames not yet resident)
and feed.decodes.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.roi import roi_batch
from tcam_wsol_video_tpu_torch.cams.temporal import fuse_temporal_max
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.data.transforms import crop_flip, to_device
from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear
from tcam_wsol_video_tpu_torch.ops.otsu import otsu_threshold_skimage255
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh


def assemble_cam_planes(windows, cam_valid, ys, xs, flips, t,
                        threshs, c: int, r: int, roi_method: str,
                        p_min_area: float, use_roi: bool
                        ) -> Dict[str, torch.Tensor]:
    """A batch's CAM planes from its stored CAM windows, in one batched
    pass on the windows' device: each window heat-fused (t > 0) by max,
    resized to (r, r), cropped at (ys, xs), flipped where flips, clipped
    to [0, 1], then its ROI and foreground size.  windows (B, T, h, w)
    float32, cam_valid (B, T) bool, threshs (B,) stored thresholds in
    [0, 255] (< 0: Otsu's).  Returns std_cam (B, c, c), has_cam (B,), roi
    (B, c, c) int32, msk_bbox (B, c, c), fg_size (B,).  No host sync, so
    it is captured in the feed's CUDA graphs; the streamed route calls it
    too (data/pipeline.py)."""
    b = windows.shape[0]
    dev = windows.device
    fused = fuse_temporal_max(windows, cam_valid, t)
    fused = resize_bilinear(fused[..., None], (r, r),
                            align_corners=False)[..., 0]
    cam_t = crop_flip(fused, c, ys, xs, flips).clamp(0.0, 1.0)
    if use_roi:
        otsu = otsu_threshold_skimage255(torch.floor(cam_t * 255.0))
        th = torch.where(threshs >= 0.0, threshs, otsu)
        roi, msk, _ = roi_batch(cam_t, roi_method, p_min_area, threshs=th)
        use_fg = roi.sum((1, 2)) > 0
    else:
        roi = torch.zeros((b, c, c), dtype=torch.int32, device=dev)
        msk = torch.ones((b, c, c), device=dev)
        use_fg = torch.zeros((b,), dtype=torch.bool, device=dev)
    fg_roi = (cam_t * (roi > 0)).sum((1, 2)) / float(c * c)
    fg = torch.where(use_fg, fg_roi, cam_t.mean((1, 2)))
    return {"std_cam": cam_t, "has_cam": torch.ones((b,), device=dev),
            "roi": roi, "msk_bbox": msk, "fg_size": fg}


def make_assemble(c: int, r: int, roi_method: str, p_min_area: float,
                  use_roi: bool, has_store: bool):
    """Returns assemble(frames_pool, cams_pool, rows, cam_rows, cam_valid,
    ys, xs, flips, t, threshs) -> the batch planes, on the pools' device:
    raw_u8 (B, c, c, 3) uint8 and assemble_cam_planes' planes of the
    windows cams_pool[cam_rows].  rows (B,) and cam_rows (B, T) are int64
    pool rows, cam_valid (B, T) bool, t the heat (a float, 0 = none, or
    a 0-d tensor on the pools' device: a heat that is on, read there),
    threshs (B,) stored thresholds in [0, 255] (< 0: Otsu's)."""

    def assemble(frames_pool, cams_pool, rows, cam_rows, cam_valid, ys, xs,
                 flips, t, threshs) -> Dict[str, torch.Tensor]:
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
        return {"raw_u8": raw_u8, **assemble_cam_planes(
            cams_pool[cam_rows], cam_valid, ys, xs, flips, t, threshs, c,
            r, roi_method, p_min_area, use_roi)}

    return assemble


class DeviceTrainFeed:
    """An epoch iterator of train batches assembled from pools on the
    pipeline's device.  Built by DataPipeline(train_device_cache_mb=...);
    `enabled` is False, and the pipeline streams, for an eval split, in a
    run of several processes, or when the frames pool would exceed the
    budget."""

    def __init__(self, pipeline, budget_mb: int):
        self.pipe = pipeline
        self.ds = ds = pipeline.ds
        self.device = pipeline.device
        self.enabled = False
        # eval splits stream; so does every rank of a multi-process run
        # (JAX's feed disables itself when process_count > 1)
        if not ds.transform.train or pmesh.world_size() > 1:
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
        self.threshs = ds.stored_threshs_255(frames)
        if self.has_store:
            self.cams_pool = torch.from_numpy(np.stack(
                [ds.cam_store.load_cam(f) for f in frames]).astype(
                    np.float32)).to(self.device)
        self.assemble = make_assemble(self.c, self.r, ds.roi_method,
                                      ds.p_min_area_roi, bool(ds.use_roi),
                                      self.has_store)
        self.enabled = True

    # ------------------------------------------------------- pool filling
    def _ensure_resident(self, rows: np.ndarray) -> None:
        """Decode the frames of `rows` that are not in the pool yet, by
        the pipeline's image route.  On the card the decode runs on
        nvJPEG's side stream and the insert on the current stream, after
        the work that reads the pool."""
        missing = ~self.resident[rows]
        TRACE.count("feed.misses", int(missing.sum()))
        miss = np.unique(rows[missing])
        if miss.size == 0:
            return
        frames = self.pipe.codec.decode_resize_u8(
            [f"{self.ds.data_root}/{self.frames[i]}" for i in miss], self.r,
            self.device)
        self.frames_pool[to_device(miss, self.device)] = frames
        self.resident[miss] = True
        self.decodes[miss] += 1
        TRACE.count("feed.decodes", int(miss.size))

    # ------------------------------------------------------------- epochs
    def _plan_epoch(self, epoch: int, subset: Optional[np.ndarray] = None):
        """The epoch's sampling plan on the host: the pipeline's batch
        plans (DataPipeline.plan_batches) stacked, their frames mapped to
        pool rows, CAM windows and stored thresholds and tiled.  Returns
        (plan {name: (n_steps, target[, T]) array}, per-step frame ids,
        the heat t)."""
        ds = self.ds
        t_cap = ds.cam_window_len()
        t_heat = ds.cam_heat()
        steps = []
        all_ids: List[List[str]] = []
        for p in self.pipe.plan_batches(epoch, subset):
            ids = p["ids"]
            rows = np.asarray([self.row_of[f] for f in ids], np.int64)
            cam_rows = np.zeros((len(ids), t_cap), np.int64)
            cam_valid = np.zeros((len(ids), t_cap), bool)
            if self.has_store:
                for m, fid in enumerate(ids):
                    for w, wid in enumerate(ds.cam_window(fid)):
                        cam_rows[m, w] = self.row_of[wid]
                        cam_valid[m, w] = True
            step = {"rows": rows, "cam_rows": cam_rows,
                    "cam_valid": cam_valid, "ys": p["ys"], "xs": p["xs"],
                    "flips": p["flips"], "threshs": self.threshs[rows],
                    "label": p["label"], "seq_iter": p["seq_iter"],
                    "frm_iter": p["frm_iter"]}
            tile = p["tile"]
            if tile is not None:
                step = {k: v[tile] for k, v in step.items()}
                ids = [ids[i] for i in tile]
            step["valid"] = p["valid"]
            steps.append(step)
            all_ids.append(ids)
        if not steps:
            return {}, [], t_heat
        plan = {key: np.stack([st[key] for st in steps]) for key in steps[0]}
        return plan, all_ids, t_heat

    def epoch_plan(self, epoch: int, subset: Optional[np.ndarray] = None):
        """The epoch's plan for the chunked runner (engine/scan_train.py),
        with every frame it touches made resident in one burst before the
        first dispatch (JAX DeviceTrainFeed.epoch_plan).  Returns (plan
        {name: (n_steps, target[, T]) host array}, per-step frame ids, the
        heat t)."""
        self.ds.set_epoch(epoch)
        with TRACE.span("feed.plan"):
            plan, all_ids, t_heat = self._plan_epoch(epoch, subset)
        if all_ids:
            rows = np.unique(plan["rows"])
            TRACE.count("feed.frames", rows.size)
            with TRACE.span("feed.fill"):
                self._ensure_resident(rows)
        return plan, all_ids, t_heat

    def epoch(self, epoch: int, subset: Optional[np.ndarray] = None
              ) -> Iterator[dict]:
        """The epoch's batches on the pools' device: the assembly's planes
        plus label, seq_iter, frm_iter, valid and image_id."""
        with TRACE.span("feed.plan"):
            plan, all_ids, t_heat = self._plan_epoch(epoch, subset)
            dev = {k: to_device(v, self.device) for k, v in plan.items()}
        if not all_ids:
            return
        TRACE.count("feed.frames", np.unique(plan["rows"]).size)
        for s in range(len(all_ids)):
            with TRACE.span("data.pixels"):
                self._ensure_resident(plan["rows"][s])
            with TRACE.span("feed.assemble"):
                batch = self.assemble(
                    self.frames_pool, self.cams_pool, dev["rows"][s],
                    dev["cam_rows"][s], dev["cam_valid"][s], dev["ys"][s],
                    dev["xs"][s], dev["flips"][s], t_heat,
                    dev["threshs"][s])
            for key in ("label", "seq_iter", "frm_iter", "valid"):
                batch[key] = dev[key][s]
            batch["image_id"] = all_ids[s]
            yield batch
