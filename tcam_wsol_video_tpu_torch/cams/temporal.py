"""DecayTemp, the epoch schedule of the CAM heating factor and the seed
technique (port of cams/temporal.py DecayTemp).

The heat t anneals linearly from sl_tc_knn_t to sl_tc_min_t over
sl_tc_knn_epoch_switch_uniform epochs, and from that epoch on the seed
technique is uniform; with the switch at -1 nothing decays.  The trainer
sets the epoch, the dataset reads `t`.
"""
from __future__ import annotations

from dataclasses import dataclass

from tcam_wsol_video_tpu_torch.core import constants


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
