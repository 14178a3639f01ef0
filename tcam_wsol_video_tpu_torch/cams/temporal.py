"""Temporal CAM fusion and its schedule (port of cams/temporal.py).

`heat_cam` and `fuse_temporal_max` heat the stored CAMs of a frame's
neighbours with exp((cam + 1e-6) t) / max and fuse them by elementwise
max, batched on tensors (the card-resident train feed's fusion).

DecayTemp is the epoch schedule of the CAM heating factor and the seed
technique.  The heat t anneals linearly from sl_tc_knn_t to sl_tc_min_t over
sl_tc_knn_epoch_switch_uniform epochs, and from that epoch on the seed
technique is uniform; with the switch at -1 nothing decays.  The trainer
sets the epoch, the dataset reads `t`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from tcam_wsol_video_tpu_torch.core import constants


def heat_cam(cam: torch.Tensor, t: float) -> torch.Tensor:
    """exp((cam + 1e-6) t) / max over the last two axes; nan -> 0,
    +inf -> 1, -inf -> 0."""
    e = torch.exp((cam + 1e-6) * t)
    e = e / e.amax((-2, -1), keepdim=True)
    return torch.nan_to_num(e, nan=0.0, posinf=1.0, neginf=0.0)


def fuse_temporal_max(cams: torch.Tensor, valid: torch.Tensor,
                      t=0.0) -> torch.Tensor:
    """cams (B, T, H, W) neighbour stacks, valid (B, T) bool -> (B, H, W):
    each valid CAM heated when t > 0, then the max over T; a row without
    a valid CAM gives 0.  t a float, or a 0-d tensor read on the device:
    a heat that is on (the chunked route hands one over only then)."""
    if isinstance(t, torch.Tensor):
        h = heat_cam(cams, t.clamp_min(1e-12))
    else:
        h = heat_cam(cams, max(t, 1e-12)) if t > 0 else cams
    h = torch.where(valid[..., None, None], h, float("-inf"))
    out = h.amax(1)
    return torch.where(torch.isfinite(out), out, 0.0)


@dataclass
class DecayTemp:
    sl_tc_knn_t: float
    sl_tc_min_t: float
    sl_tc_knn: int
    sl_tc_knn_mode: str
    sl_tc_knn_epoch_switch_uniform: int
    sl_tc_seed_tech: str
    epoch: int = 0

    def __post_init__(self):
        if self.sl_tc_knn_t < self.sl_tc_min_t:
            raise ValueError("sl_tc_knn_t must be >= sl_tc_min_t")
        if self.sl_tc_knn_mode not in constants.TIME_DEPENDENCY:
            raise ValueError(f"sl_tc_knn_mode {self.sl_tc_knn_mode!r}")
        if self.sl_tc_seed_tech not in constants.SEED_TECHS:
            raise ValueError(f"sl_tc_seed_tech {self.sl_tc_seed_tech!r}")
        sw = self.sl_tc_knn_epoch_switch_uniform
        self.decayable = sw != -1
        if self.decayable and sw > 0:
            self.decay = (self.sl_tc_knn_t - self.sl_tc_min_t) / float(sw)
        else:
            self.decay = 0.0

    @property
    def t(self) -> float:
        if not self.decayable:
            return self.sl_tc_knn_t
        return max(self.sl_tc_min_t,
                   self.sl_tc_knn_t - self.epoch * self.decay)

    @property
    def seed_tech(self) -> str:
        if (self.decayable
                and self.epoch >= self.sl_tc_knn_epoch_switch_uniform):
            return constants.SEED_UNIFORM
        return self.sl_tc_seed_tech

    def set_epoch(self, epoch: int) -> None:
        if epoch < 0:
            raise ValueError(f"epoch {epoch} < 0")
        self.epoch = int(epoch)
