"""Localization evaluation over a split (port of engine/evaluator.py
CamEvaluator, host-sweep branch).

Each batch runs the eval step on the pipeline's device (for STD_CL the
CAM of each image's label class); the CAMs come back to the host, where
the exact all-threshold box sweep (metrics/native_sweep) scores every
valid image against its GT boxes and BoxEvaluator counts MaxBoxAcc at
each IoU threshold.  Classification
counts the top-1 prediction of every valid image.  Validation above 1000
samples sweeps the coarse tau grid.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.engine.steps import make_cam_eval_step
from tcam_wsol_video_tpu_torch.metrics import native_sweep
from tcam_wsol_video_tpu_torch.metrics.wsol import BoxEvaluator

logger = logging.getLogger(__name__)


def cam_threshold_list(interval: float) -> np.ndarray:
    return np.arange(0.0, 1.0, interval)


class CamEvaluator:
    def __init__(self, model, args, dataset, pipeline, split: str,
                 fast: bool = False, max_gt_boxes: int = 8,
                 generator: Optional[torch.Generator] = None):
        """generator: the noise of the CAM methods that draw it
        (SmoothGradCAM++, SSCAM), on the pipeline's device."""
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

    def run(self) -> Dict:
        """Scores the split.  Returns maxboxacc_<s>, top1_loc_<s>,
        top5_loc_<s>, best_tau, curves, localization, classification,
        n_images and `timing` (wall seconds, forward ms per batch, sweep
        ms per image, images per second)."""
        args = self.args
        evaluator = BoxEvaluator(self.taus, args.iou_threshold_list,
                                 multi_contour_eval=args.multi_contour_eval)
        use_raw = bool(args.crf_post_process)
        n_correct_cl = 0
        n_total = 0
        forward_ms, sweep_s = [], 0.0
        t_start = time.perf_counter()
        for batch in self.pipe.epoch(0):
            t0 = time.perf_counter()
            # a compact batch (h2d_transfer=uint8) holds uint8 pixels only:
            # the step normalizes them and takes them as the raw image
            cams, logits = self.eval_step(
                batch.get("raw_u8", batch.get("image")),
                batch["raw_img"] if use_raw and "raw_img" in batch
                else None, targets=batch["label"],
                generator=self.generator)
            cams_np = cams.float().cpu().numpy()
            logits_np = logits.float().cpu().numpy()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
            labels = batch["label"].cpu().numpy()
            valid = batch["valid"].cpu().numpy()
            preds = np.argsort(-logits_np, axis=-1, kind="stable")
            n_correct_cl += int(((preds[:, 0] == labels) & valid).sum())
            n_total += int(valid.sum())
            idxs = [i for i in range(cams_np.shape[0]) if valid[i]]
            if not idxs:
                continue
            gt_boxes, gt_valid = self._gt_batch(batch["image_id"])
            t0 = time.perf_counter()
            best, _ = native_sweep.sweep_best_iou(
                cams_np[idxs], evaluator.cam_threshold_list,
                [gt_boxes[i][gt_valid[i]] for i in idxs])
            sweep_s += time.perf_counter() - t0
            for j, i in enumerate(idxs):
                evaluator.accumulate_best_iou(best[j], int(labels[i]),
                                              preds[i])
        wall = time.perf_counter() - t_start

        out: Dict = {}
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
        accs_only = [out[f"maxboxacc_{s}"] for s in args.iou_threshold_list]
        out["localization"] = (float(np.mean(accs_only))
                               if args.multi_iou_eval
                               else out["maxboxacc_50"])
        out["classification"] = 100.0 * n_correct_cl / max(n_total, 1)
        out["timing"] = {
            "seconds": wall, "batches": len(forward_ms),
            "forward_ms_per_batch": float(np.median(forward_ms)),
            "sweep_ms_per_image": 1e3 * sweep_s / max(n_total, 1),
            "images_per_s": n_total / wall}
        return out
