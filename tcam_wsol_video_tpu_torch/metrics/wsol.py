"""MaxBoxAcc counters of the box protocol (port of metrics/wsol.py
BoxEvaluator, fed by the native sweep's per-tau best IoU, by the device
sweep's per-level hits or by scoremap_to_boxes), PxAP over GT masks
(MaskEvaluator) and the classification accuracy.

scoremap_to_boxes is the protocol's per-threshold box rule: render the
map to uint8, threshold at int(tau peak) with strict >, take the borders
that cv2.findContours(RETR_TREE) returns (ops/contours.py traces them
without cv2), their boundingRect with x1 / y1 clamped to W-1 / H-1; the
single-largest-contour protocol (multi_contour False) keeps the first
border of largest contourArea; an empty mask gives one [0, 0, 0, 0] box.

Per IoU threshold sigma in iou_threshold_list and per CAM threshold tau,
an image counts when its best box IoU at tau is >= sigma / 100; MaxBoxAcc
is the best tau's share, in percent.  top1 / top5 count only images whose
class is the first / among the first five predictions.  C_BOX predicts
its box directly (accumulate_bbox): the same box at every tau, and an
invalid box a miss at every tau.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.ops import contours
from tcam_wsol_video_tpu_torch.ops.boxes import iou_matrix_np
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh


def scoremap_to_boxes(scoremap: np.ndarray, taus: Sequence[float],
                      multi_contour: bool = False
                      ) -> Tuple[List[np.ndarray], List[int]]:
    """Boxes per threshold of one (H, W) map in [0, 1]: ([(k_i, 4)
    float64 x0 y0 x1 y1], [k_i]) over taus."""
    scoremap = np.asarray(scoremap)
    if scoremap.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {scoremap.shape}")
    if np.isnan(scoremap).any():
        raise ValueError("the score map holds NaN")
    if scoremap.min() < 0 or scoremap.max() > 1:
        raise ValueError(f"the score map leaves [0, 1]: "
                         f"{scoremap.min()}, {scoremap.max()}")
    h, w = scoremap.shape
    img8 = (scoremap * 255).astype(np.uint8)
    peak = int(img8.max())
    # the protocol's int(tau * peak), tau by tau as Python floats
    levels = np.asarray([int(t * peak) for t in taus], np.int64)
    uniq, inverse = np.unique(levels, return_inverse=True)
    rows = contours.sweep(img8, uniq, multi_contour)
    starts = np.searchsorted(rows[:, 0], np.arange(len(uniq) + 1))
    per_level: List[np.ndarray] = []
    for li in range(len(uniq)):
        r = rows[starts[li]:starts[li + 1]]
        if len(r) == 0:
            per_level.append(np.zeros((1, 4), np.float64))
            continue
        x, y, bw, bh = r[:, 1], r[:, 2], r[:, 3], r[:, 4]
        per_level.append(np.stack(
            [x, y, np.minimum(x + bw, w - 1), np.minimum(y + bh, h - 1)],
            1).astype(np.float64))
    boxes = [per_level[i] for i in inverse.ravel()]
    return boxes, [len(b) for b in boxes]


class BoxEvaluator:
    def __init__(self, cam_threshold_list: Sequence[float],
                 iou_threshold_list: Sequence[int] = (30, 50, 70),
                 multi_contour_eval: bool = True):
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

    def accumulate(self, scoremap: Optional[np.ndarray],
                   gt_boxes: np.ndarray, target: int,
                   preds_ordered: np.ndarray, precomputed=None) -> None:
        """One image through scoremap_to_boxes under this evaluator's
        protocol (or its result given as `precomputed`), scored against
        gt_boxes (G, 4) at every tau."""
        if precomputed is None:
            precomputed = scoremap_to_boxes(
                scoremap, self.cam_threshold_list, self.multi_contour_eval)
        boxes_per_tau, counts = precomputed
        iou = iou_matrix_np(np.concatenate(boxes_per_tau, axis=0),
                            np.asarray(gt_boxes, np.float64))
        best_per_box = iou.max(axis=1)
        per_tau = np.maximum.reduceat(
            best_per_box, np.concatenate([[0], np.cumsum(counts)[:-1]]))
        self.accumulate_best_iou(per_tau, target, preds_ordered)

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


class MaskEvaluator:
    """PxAP over GT masks (OpenImages; JAX MaskEvaluator): histograms of
    the map's values inside and outside the mask over the bins [taus...,
    1, 2, 3] (the two last catch the scores above the last tau), then the
    area under the precision-recall curve from the highest bin down."""

    def __init__(self, cam_threshold_list: Sequence[float]):
        self.cam_threshold_list = list(cam_threshold_list)
        self.edges = np.append(np.asarray(self.cam_threshold_list),
                               [1.0, 2.0, 3.0])
        n = len(self.cam_threshold_list) + 2
        self.gt_true_hist = np.zeros(n)
        self.gt_false_hist = np.zeros(n)
        self.cnt = 0

    def accumulate(self, scoremap: np.ndarray, gt_mask: np.ndarray) -> None:
        gt = gt_mask > 0.5
        sm = np.asarray(scoremap).astype(np.float64)
        self.gt_true_hist += np.histogram(sm[gt], bins=self.edges)[0]
        self.gt_false_hist += np.histogram(sm[~gt], bins=self.edges)[0]
        self.cnt += 1

    def counters(self) -> np.ndarray:
        """The image count and both histograms, flat (float64)."""
        return np.concatenate([[float(self.cnt)], self.gt_true_hist,
                               self.gt_false_hist])

    def set_counters(self, flat: np.ndarray) -> None:
        n = len(self.gt_true_hist)
        self.cnt = int(flat[0])
        self.gt_true_hist = np.asarray(flat[1:1 + n], np.float64)
        self.gt_false_hist = np.asarray(flat[1 + n:1 + 2 * n], np.float64)

    def reduce_across_devices(self, mesh=None, device=None) -> None:
        """Sums the histograms over the mesh's dp group (the identity
        without one)."""
        self.set_counters(pmesh.psum_across(self.counters(), mesh,
                                            device=device))

    def compute(self) -> float:
        n_true = self.gt_true_hist.sum()
        n_false = self.gt_false_hist.sum()
        tp = self.gt_true_hist[::-1].cumsum()
        fp = self.gt_false_hist[::-1].cumsum()
        nonzero = (tp + fp) != 0
        with np.errstate(invalid="ignore", divide="ignore"):
            precision = tp / (tp + fp)
        recall = tp / max(n_true, 1)
        if n_false == 0 and n_true == 0:
            return 0.0
        ap = float((precision[1:] * np.diff(recall))[nonzero[1:]].sum())
        return ap * 100.0


def classification_accuracy(preds: np.ndarray, targets: np.ndarray
                            ) -> float:
    return float((preds == targets).mean() * 100.0)
