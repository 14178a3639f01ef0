"""Seed-quality diagnostics (port of metrics/seeds_eval.py): the share of
sampled foreground seeds inside the GT object mask and of background
seeds outside it, and the seeds an image draws.

Seeds are 1 (foreground), 0 (background) or the ignore index; the mask is
binary at the seeds' resolution.  Each rate is averaged over the seeds,
the counts over the images.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class RunningMeter:
    """A running average weighted by n."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class SeedAccuracy:
    def __init__(self, ignore_idx: int = -255):
        self.ignore = ignore_idx
        self.fg_acc = RunningMeter()
        self.bg_acc = RunningMeter()
        self.fg_count = RunningMeter()
        self.bg_count = RunningMeter()

    def update(self, seeds: np.ndarray, gt_mask: np.ndarray) -> None:
        fg = seeds == 1
        bg = seeds == 0
        n_fg = int(fg.sum())
        n_bg = int(bg.sum())
        if n_fg:
            self.fg_acc.update(float((gt_mask[fg] > 0).mean()), n_fg)
        if n_bg:
            self.bg_acc.update(float((gt_mask[bg] == 0).mean()), n_bg)
        self.fg_count.update(n_fg)
        self.bg_count.update(n_bg)

    def summary(self) -> Dict[str, float]:
        return {
            "seed_fg_precision": self.fg_acc.avg * 100.0,
            "seed_bg_precision": self.bg_acc.avg * 100.0,
            "seed_fg_per_image": self.fg_count.avg,
            "seed_bg_per_image": self.bg_count.avg,
        }
