"""MaxBoxAcc counters of the box protocol (port of metrics/wsol.py
BoxEvaluator, fed by the native sweep's per-tau best IoU or by the device
sweep's per-level hits) and the classification accuracy.

Per IoU threshold sigma in iou_threshold_list and per CAM threshold tau,
an image counts when its best box IoU at tau is >= sigma / 100; MaxBoxAcc
is the best tau's share, in percent.  top1 / top5 count only images whose
class is the first / among the first five predictions.  C_BOX predicts
its box directly (accumulate_bbox): the same box at every tau, and an
invalid box a miss at every tau.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from tcam_wsol_video_tpu_torch.ops.boxes import iou_matrix_np


class BoxEvaluator:
    def __init__(self, cam_threshold_list: Sequence[float],
                 iou_threshold_list: Sequence[int] = (30, 50, 70),
                 multi_contour_eval: bool = True):
        if not multi_contour_eval:
            raise NotImplementedError(
                "the single-largest-contour protocol (cv2) is not ported")
        self.cam_threshold_list = list(cam_threshold_list)
        self.iou_threshold_list = list(iou_threshold_list)
        self.multi_contour_eval = multi_contour_eval
        n_tau = len(self.cam_threshold_list)
        self.num_correct = {s: np.zeros(n_tau) for s in iou_threshold_list}
        self.num_correct_top1 = {s: np.zeros(n_tau)
                                 for s in iou_threshold_list}
        self.num_correct_top5 = {s: np.zeros(n_tau)
                                 for s in iou_threshold_list}
        self.cnt = 0
        self.best_tau_list: List[float] = []
        self.curves: Dict = {}
        self.top1: List[float] = []
        self.top5: List[float] = []

    def accumulate_level_hits(self, level_hits: np.ndarray, peak: int,
                              target: int,
                              preds_ordered: np.ndarray) -> None:
        """One image from the device sweep (metrics/device_sweep.
        level_hits): level_hits (256, S) bool, S ordered as
        iou_threshold_list; peak the uint8 rendering's max.  Each tau
        maps to its level by the protocol's int(tau peak) truncation."""
        levels = (np.asarray(self.cam_threshold_list, np.float64)
                  * int(peak)).astype(np.int64)
        np.clip(levels, 0, 255, out=levels)
        hits = level_hits[levels]                       # (n_tau, S)
        top1_hit = target == preds_ordered[0]
        top5_hit = target in preds_ordered[:5]
        for si, sigma in enumerate(self.iou_threshold_list):
            h = hits[:, si].astype(np.float64)
            self.num_correct[sigma] += h
            if top1_hit:
                self.num_correct_top1[sigma] += h
            if top5_hit:
                self.num_correct_top5[sigma] += h
        self.cnt += 1

    def accumulate_best_iou(self, per_tau: np.ndarray, target: int,
                            preds_ordered: np.ndarray) -> None:
        """One image, given its per-tau best IoU (metrics/native_sweep)."""
        top1_hit = target == preds_ordered[0]
        top5_hit = target in preds_ordered[:5]
        for sigma in self.iou_threshold_list:
            hit = per_tau >= sigma / 100.0
            self.num_correct[sigma] += hit
            if top1_hit:
                self.num_correct_top1[sigma] += hit
            if top5_hit:
                self.num_correct_top5[sigma] += hit
        self.cnt += 1

    def accumulate_bbox(self, bbox: Sequence[float], bbox_status: int,
                        gt_boxes: np.ndarray, target: int,
                        preds_ordered: np.ndarray) -> None:
        """One image of C_BOX (JAX BoxEvaluator.accumulate's bbox path):
        its predicted box (x0, y0, x1, y1) scored against gt_boxes (G, 4)
        at every tau; bbox_status 0 (an invalid box) counts the image with
        no hit."""
        if bbox_status not in (0, 1):
            raise ValueError(f"bbox_status must be 0 or 1: {bbox_status}")
        if bbox_status == 0:
            self.cnt += 1
            return
        best = iou_matrix_np(np.asarray([bbox], np.float64),
                             np.asarray(gt_boxes, np.float64)).max()
        self.accumulate_best_iou(
            np.full(len(self.cam_threshold_list), best), target,
            preds_ordered)

    def counters(self) -> np.ndarray:
        """The image count and every counter, flat (float64), in the order
        that set_counters reads."""
        parts = [np.asarray([self.cnt], np.float64)]
        for tracker in (self.num_correct, self.num_correct_top1,
                        self.num_correct_top5):
            parts += [np.asarray(tracker[s], np.float64)
                      for s in self.iou_threshold_list]
        return np.concatenate(parts)

    def set_counters(self, flat: np.ndarray) -> None:
        """The inverse of counters (the ranks' sums, JAX's
        reduce_across_devices)."""
        self.cnt = int(flat[0])
        n_tau, i = len(self.cam_threshold_list), 1
        for tracker in (self.num_correct, self.num_correct_top1,
                        self.num_correct_top5):
            for s in self.iou_threshold_list:
                tracker[s] = np.asarray(flat[i:i + n_tau], np.float64)
                i += n_tau

    def compute(self) -> List[float]:
        if self.cnt == 0:
            raise ValueError("no image was accumulated")
        max_box_acc = []
        self.best_tau_list = []
        self.curves = {"x": self.cam_threshold_list, "top1": {}, "top5": {}}
        self.top1, self.top5 = [], []
        for sigma in self.iou_threshold_list:
            acc = self.num_correct[sigma] * 100.0 / self.cnt
            max_box_acc.append(float(acc.max()))
            self.best_tau_list.append(
                float(self.cam_threshold_list[int(np.argmax(acc))]))
            self.curves[sigma] = acc
            acc1 = self.num_correct_top1[sigma] * 100.0 / self.cnt
            acc5 = self.num_correct_top5[sigma] * 100.0 / self.cnt
            self.top1.append(float(acc1.max()))
            self.top5.append(float(acc5.max()))
            self.curves["top1"][sigma] = acc1
            self.curves["top5"][sigma] = acc5
        return max_box_acc


def classification_accuracy(preds: np.ndarray, targets: np.ndarray
                            ) -> float:
    return float((preds == targets).mean() * 100.0)
