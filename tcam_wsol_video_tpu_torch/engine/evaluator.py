"""Localization evaluation over a split (port of engine/evaluator.py
CamEvaluator: the box protocol and its knobs).

Each batch runs the eval step on the pipeline's device (for STD_CL the
CAM of each image's label class); the exact all-threshold box sweep then
scores every valid image against its GT boxes, and BoxEvaluator counts
MaxBoxAcc at each IoU threshold.  Classification counts the top-1
prediction of every valid image.  Validation above 1000 samples sweeps the
coarse tau grid.

The knobs, with JAX's defaults and meaning:
- eval_sweep: where the exact sweep runs.  `host` (native/boxsweep.cpp
  over the CAMs read back) or `device` (metrics/device_sweep on the CAMs'
  device: only (B, 256, S) hit bits and the peaks are read back; an image
  whose run count overflows the sweep's cap is swept on the host, counted
  in sweep_fallbacks, and past 50% of the images so far the device sweep
  is turned off for the rest of the pass, as in JAX).  `auto` is the
  device sweep on a TPU only, so it is the host sweep here.
- eval_transfer: the CAMs' readback dtype (engine/steps.pack_cams); the
  counters are the same for each.
- eval_pipeline_depth: up to this many batches in flight.  Each batch's
  results go to pinned host buffers without waiting, behind a CUDA event;
  the oldest batch is swept on the host while the later forwards run.
  Depth 1 is the serial loop.
- eval_device_cache (budget eval_device_cache_mb): the first pass over a
  pipeline keeps its prepared batches on the device, weakly keyed by the
  pipeline; later passes replay them without the data pipeline.  Over the
  budget the recording is dropped and the pass streams.
- on_device (on_device_eval): the approximate covering-box counters of
  metrics/device_eval, summed on the device, for model selection only.
"""
from __future__ import annotations

import collections
import logging
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import SpanClock
from tcam_wsol_video_tpu_torch.data.transforms import to_device
from tcam_wsol_video_tpu_torch.engine.steps import (dequantize_cams_np,
                                                    make_cam_eval_step)
from tcam_wsol_video_tpu_torch.metrics import (device_eval, device_sweep,
                                               native_sweep)
from tcam_wsol_video_tpu_torch.metrics.wsol import BoxEvaluator

logger = logging.getLogger(__name__)

# eval_device_cache: the prepared batches of a pipeline's pass, on the
# device, weakly keyed by the pipeline (the trainer keeps one a split)
_DEVICE_EVAL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cam_threshold_list(interval: float) -> np.ndarray:
    return np.arange(0.0, 1.0, interval)


def _to_host(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A device tensor's copy into pinned host memory, not waited for (the
    caller records an event after it); a CPU tensor as it is."""
    if t is None or t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class CamEvaluator:
    def __init__(self, model, args, dataset, pipeline, split: str,
                 fast: bool = False, max_gt_boxes: int = 8,
                 generator: Optional[torch.Generator] = None,
                 on_device: Optional[bool] = None):
        """generator: the noise of the CAM methods that draw it
        (SmoothGradCAM++, SSCAM), on the pipeline's device.  on_device:
        the approximate device counters (default args.on_device_eval)."""
        self.model = model
        self.generator = generator
        self.args = args
        self.ds = dataset
        self.pipe = pipeline
        self.split = split
        interval = args.cam_curve_interval
        if (fast and split == constants.VALIDSET
                and len(dataset) > constants.FAST_EVAL_SAMPLES_THRESHOLD):
            interval = constants.VALID_FAST_CAM_CURVE_INTERVAL
        self.taus = cam_threshold_list(interval)
        self.max_gt_boxes = max_gt_boxes
        self.on_device = bool(getattr(args, "on_device_eval", False)
                              if on_device is None else on_device)
        # 'auto' is JAX's device sweep on a TPU backend only
        self.use_dev_sweep = (
            not self.on_device and args.multi_contour_eval
            and str(getattr(args, "eval_sweep", "auto")) == "device")
        self._sweep_fallbacks = 0   # images swept on the host by the cap
        self._sweep_seen = 0        # images through the device sweep
        self._sweep_disabled = False
        self.eval_step = make_cam_eval_step(model, args)

    def _gt_batch(self, image_ids):
        """(n, max_gt_boxes, 4) boxes and their mask.  Boxes past the cap
        are dropped, as the JAX evaluator drops them, with a warning."""
        g = self.max_gt_boxes
        boxes = np.zeros((len(image_ids), g, 4), np.float32)
        valid = np.zeros((len(image_ids), g), bool)
        for i, iid in enumerate(image_ids):
            b = self.ds.eval_gt_boxes(iid)
            if len(b) > g:
                logger.warning("%s has %d GT boxes; only the first %d are "
                               "scored (max_gt_boxes)", iid, len(b), g)
            b = b[:g]
            boxes[i, :len(b)] = b
            valid[i, :len(b)] = True
        return boxes, valid

    def _prep(self, batch: dict) -> tuple:
        """(pixels, labels, valid, raw or None, gt boxes, gt mask, image
        ids): a compact batch (h2d_transfer=uint8) holds uint8 pixels only,
        which the step normalizes and takes as the raw image."""
        raw = (batch["raw_img"] if self.args.crf_post_process
               and "raw_img" in batch else None)
        gt_boxes, gt_valid = self._gt_batch(batch["image_id"])
        return (batch.get("raw_u8", batch.get("image")), batch["label"],
                batch["valid"], raw, gt_boxes, gt_valid,
                list(batch["image_id"]))

    def run(self) -> Dict:
        """Scores the split.  Returns maxboxacc_<s>, localization,
        classification, n_images and `timing` (wall seconds, batches, the
        eval step's ms per batch, the host sweep's ms per image, images
        per second, and the knobs that ran); with the exact sweep also
        top1_loc_<s>, top5_loc_<s>, best_tau and curves; with the device
        sweep sweep_fallbacks."""
        args = self.args
        evaluator = BoxEvaluator(self.taus, args.iou_threshold_list,
                                 multi_contour_eval=args.multi_contour_eval)
        sigmas100 = tuple(int(s) for s in args.iou_threshold_list)
        depth = max(1, int(getattr(args, "eval_pipeline_depth", 8)))
        cache_ok = bool(getattr(args, "eval_device_cache", False))
        cached = _DEVICE_EVAL_CACHE.get(self.pipe) if cache_ok else None
        budget = int(getattr(args, "eval_device_cache_mb", 1024)) << 20
        rec = {"on": cache_ok and cached is None, "bytes": 0, "items": []}
        counts = {"correct": 0, "total": 0, "sweep_s": 0.0}
        dev = {"counters": None, "count": None}
        clock = SpanClock(self.pipe.device)

        def batches():
            if cached is not None:
                yield from cached
                return
            for batch in self.pipe.epoch(0):
                item = self._prep(batch)
                if rec["on"]:
                    rec["bytes"] += sum(t.numel() * t.element_size()
                                        for t in item[:4] if t is not None)
                    if rec["bytes"] > budget:
                        rec["on"] = False
                        rec["items"] = []
                    else:
                        rec["items"].append(item)
                yield item

        def dispatch(item) -> tuple:
            images, labels, valid, raw, gt_boxes, gt_valid, ids = item
            begin = clock.start()
            cams, logits = self.eval_step(images, raw, targets=labels,
                                          generator=self.generator)
            clock.stop(begin)
            sweep = self.use_dev_sweep and not self._sweep_disabled
            out = {"logits": logits, "labels": labels, "valid": valid}
            if self.on_device:
                self._device_counters(cams, gt_boxes, gt_valid, valid, dev)
            elif sweep:
                out["hits"], out["peak"], out["fb"] = \
                    device_sweep.sweep_batch(cams, gt_boxes, gt_valid,
                                             sigmas100)
            else:
                out["cams"] = cams
            host = {k: _to_host(v) for k, v in out.items()}
            event = None
            if images.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            return host, event, cams if sweep else None, gt_boxes, gt_valid

        def process(handle) -> None:
            host, event, cams_dev, gt_boxes, gt_valid = handle
            if event is not None:
                event.synchronize()
            logits_np = host["logits"].float().numpy()
            labels = host["labels"].numpy()
            valid = host["valid"].numpy()
            preds = np.argsort(-logits_np, axis=-1, kind="stable")
            counts["correct"] += int(((preds[:, 0] == labels) & valid).sum())
            counts["total"] += int(valid.sum())
            idxs = [i for i in range(len(valid)) if valid[i]]
            if self.on_device or not idxs:
                return
            if "hits" in host:
                self._process_sweep(host, cams_dev, idxs, labels, preds,
                                    gt_boxes, gt_valid, evaluator, counts)
                return
            cams_np = dequantize_cams_np(host["cams"].numpy())
            t0 = time.perf_counter()
            best, _ = native_sweep.sweep_best_iou(
                cams_np[idxs], evaluator.cam_threshold_list,
                [gt_boxes[i][gt_valid[i]] for i in idxs])
            counts["sweep_s"] += time.perf_counter() - t0
            for j, i in enumerate(idxs):
                evaluator.accumulate_best_iou(best[j], int(labels[i]),
                                              preds[i])

        t_start = time.perf_counter()
        inflight: collections.deque = collections.deque()
        for item in batches():
            inflight.append(dispatch(item))
            while len(inflight) >= depth:
                process(inflight.popleft())
        while inflight:
            process(inflight.popleft())
        if rec["on"] and rec["items"]:
            _DEVICE_EVAL_CACHE[self.pipe] = rec["items"]
        wall = time.perf_counter() - t_start
        forward_ms = clock.millis()

        out: Dict = {}
        n_total = counts["total"]
        if self.on_device:
            accs = device_eval.max_box_acc(dev["counters"],
                                           dev["count"].float())
            for s, a in zip(args.iou_threshold_list, accs.cpu().tolist()):
                out[f"maxboxacc_{s}"] = float(a)
            out["curves"] = None
        else:
            accs = evaluator.compute()
            for s, a in zip(args.iou_threshold_list, accs):
                out[f"maxboxacc_{s}"] = float(a)
            for s, a in zip(args.iou_threshold_list, evaluator.top1):
                out[f"top1_loc_{s}"] = float(a)
            for s, a in zip(args.iou_threshold_list, evaluator.top5):
                out[f"top5_loc_{s}"] = float(a)
            out["best_tau"] = evaluator.best_tau_list
            out["curves"] = evaluator.curves
        out["n_images"] = n_total
        if self.use_dev_sweep:
            out["sweep_fallbacks"] = self._sweep_fallbacks
        accs_only = [out[f"maxboxacc_{s}"] for s in args.iou_threshold_list]
        out["localization"] = (float(np.mean(accs_only))
                               if args.multi_iou_eval
                               else out["maxboxacc_50"])
        out["classification"] = (100.0 * counts["correct"]
                                 / max(n_total, 1))
        out["timing"] = {
            "seconds": wall, "batches": len(forward_ms),
            "forward_ms_per_batch": float(np.median(forward_ms))
            if forward_ms else 0.0,
            "sweep_ms_per_image": 1e3 * counts["sweep_s"] / max(n_total, 1),
            "images_per_s": n_total / wall,
            "sweep": ("on_device" if self.on_device else "device"
                      if self.use_dev_sweep else "host"),
            "pipeline_depth": depth,
            "device_cache": ("replayed" if cached is not None else
                             "recorded" if rec["on"] and rec["items"] else
                             "over_budget" if cache_ok else "off")}
        return out

    def _device_counters(self, cams, gt_boxes, gt_valid, valid, dev) -> None:
        """on_device: the batch's approximate counters, summed on the
        device (uint16/uint8 CAMs unpacked first)."""
        if cams.dtype == torch.uint16:
            cams = cams.to(torch.int32).float() / 65535.0
        elif cams.dtype == torch.uint8:
            cams = cams.float() / 255.0
        d = cams.device
        taus = torch.from_numpy(np.asarray(self.taus, np.float32)).to(d)
        sigmas = torch.tensor([s / 100.0 for s in
                               self.args.iou_threshold_list],
                              dtype=torch.float32).to(d)
        gv = to_device(gt_valid, d) & valid[:, None].bool()
        c = device_eval.batch_counters(cams, to_device(gt_boxes, d), gv,
                                       taus, sigmas)
        n = valid.bool().sum()
        dev["counters"] = c if dev["counters"] is None else dev["counters"] + c
        dev["count"] = n if dev["count"] is None else dev["count"] + n

    def _process_sweep(self, host, cams_dev, idxs, labels, preds, gt_boxes,
                       gt_valid, evaluator, counts) -> None:
        """The device sweep's batch on the host: level hits into the
        counters; the images whose fallback bit is set through the host
        sweep (their CAMs read back), counted."""
        hits = host["hits"].numpy()
        peaks = host["peak"].numpy()
        fb = host["fb"].numpy()
        fall = [i for i in idxs if fb[i]]
        best = {}
        if fall:
            cams_np = dequantize_cams_np(cams_dev[fall].cpu().numpy())
            t0 = time.perf_counter()
            b, _ = native_sweep.sweep_best_iou(
                cams_np, evaluator.cam_threshold_list,
                [gt_boxes[i][gt_valid[i]] for i in fall])
            counts["sweep_s"] += time.perf_counter() - t0
            best = dict(zip(fall, b))
        for i in idxs:
            if i in best:
                evaluator.accumulate_best_iou(best[i], int(labels[i]),
                                              preds[i])
            else:
                evaluator.accumulate_level_hits(hits[i], int(peaks[i]),
                                                int(labels[i]), preds[i])
        self._sweep_fallbacks += len(fall)
        self._sweep_seen += len(idxs)
        if self._sweep_fallbacks > 0.5 * max(self._sweep_seen, 1):
            self._sweep_disabled = True
