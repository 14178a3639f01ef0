"""The hparams keys the stage-2 TCAM slice reads.

Names and defaults are those of the JAX package's core/hparams.py
`get_config` (YouTube-Objects-v1.0 defaults), so a recipe written for one
package reads the same in the other.  The full hparams/CLI port is later
work; `stage2_tcam_recipe` gives the stage-2 flags of the end-to-end
script, `stage2_tcam_production` those of the production stage-2 script
(landmark CRF).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from tcam_wsol_video_tpu_torch.core import constants


@dataclass
class TCAMConfig:
    # experiment
    num_classes: int = constants.NUMBER_CLASSES[constants.YTOV1]
    crop_size: int = constants.CROP_SIZE
    batch_size: int = 32
    seed: int = 0
    # model
    task: str = constants.STD_CL
    encoder_name: str = constants.RESNET50
    spatial_pooling: str = constants.WGAP
    freeze_cl: bool = False
    seg_ignore_idx: int = constants.SEG_IGNORE_IDX
    # optimizer
    opt_name: str = "sgd"
    lr: float = 0.001
    momentum: float = 0.9
    dampening: float = 0.0
    weight_decay: float = 1e-4
    nesterov: bool = True
    lr_classifier_ratio: float = 10.0
    elb_init_t: float = 1.0
    # image reconstruction (not ported; read only to refuse it)
    im_rec: bool = False
    # clip sampling: knn_tc > 0 makes batches of clips of 2 knn_tc + 1
    # frames (the temporal joint CRF's layout)
    knn_tc: int = 0
    # self-learning seeds
    sl_tc: bool = False
    sl_tc_lambda: float = 1.0
    sl_tc_start_ep: int = 0
    sl_tc_end_ep: int = -1
    sl_tc_min: int = 10
    sl_tc_max: int = 10
    sl_tc_ksz: int = 1
    sl_tc_min_p: float = 0.2
    sl_tc_max_p: float = 0.2
    sl_tc_use_roi: bool = False
    sl_tc_seed_tech: str = constants.SEED_UNIFORM
    sl_tc_fg_erode_k: int = 11
    sl_tc_fg_erode_iter: int = 0
    sl_tc_roi_method: str = constants.ROI_ALL
    sl_tc_roi_min_size: float = 0.05
    # dense CRF
    crf_impl: str = "exact"
    crf_n_landmarks: int = 1024
    crf_rff_freqs: int = 2048
    crf_tc: bool = False
    crf_tc_lambda: float = 2e-9
    crf_tc_sigma_rgb: float = 15.0
    crf_tc_sigma_xy: float = 100.0
    crf_tc_scale: float = 1.0
    crf_tc_start_ep: int = 0
    crf_tc_end_ep: int = -1
    # ELB size prior
    max_sizepos_tc: bool = False
    max_sizepos_tc_lambda: float = 1.0
    max_sizepos_tc_start_ep: int = 0
    max_sizepos_tc_end_ep: int = -1
    # temporal joint (color-only) CRF over a clip
    rgb_jcrf_tc: bool = False
    rgb_jcrf_tc_lambda: float = 2e-9
    rgb_jcrf_tc_sigma_rgb: float = 15.0
    rgb_jcrf_tc_scale: float = 1.0
    rgb_jcrf_tc_start_ep: int = 0
    rgb_jcrf_tc_end_ep: int = -1
    # ELB: background area >= foreground area
    size_bg_g_fg_tc: bool = False
    size_bg_g_fg_tc_lambda: float = 1.0
    size_bg_g_fg_tc_start_ep: int = 0
    size_bg_g_fg_tc_end_ep: int = -1
    # ELB: no foreground outside the ROI box
    empty_out_bb_tc: bool = False
    empty_out_bb_tc_lambda: float = 1.0
    empty_out_bb_tc_start_ep: int = 0
    empty_out_bb_tc_end_ep: int = -1
    # ELB: foreground size within eps of the temporal estimate
    sizefg_tmp_tc: bool = False
    sizefg_tmp_tc_knn: int = 0
    sizefg_tmp_tc_knn_mode: str = constants.TIME_INSTANT
    sizefg_tmp_tc_eps: float = 0.001
    sizefg_tmp_tc_lambda: float = 1.0
    sizefg_tmp_tc_start_ep: int = 0
    sizefg_tmp_tc_end_ep: int = -1
    # eval: mean-field CRF refinement of the CAMs
    crf_post_process: bool = False
    crf_pp_iters: int = 5

    def replace(self, **kw) -> "TCAMConfig":
        return dataclasses.replace(self, **kw)


def stage2_tcam_recipe(**overrides) -> TCAMConfig:
    """Stage-2 flags of cmds/e2e_synth224_tpu.sh with the batch size and
    freeze_cl of config_yaml/ytov1_stage2_tcam.yaml."""
    cfg = TCAMConfig(
        task=constants.TCAM, batch_size=32,
        lr=0.01, freeze_cl=True, elb_init_t=1.0,
        sl_tc=True, sl_tc_lambda=1.0, sl_tc_min=1, sl_tc_max=1,
        sl_tc_ksz=3, sl_tc_max_p=0.6, sl_tc_min_p=0.1,
        sl_tc_seed_tech=constants.SEED_WEIGHTED, sl_tc_use_roi=True,
        sl_tc_roi_method=constants.ROI_ALL, sl_tc_roi_min_size=0.05,
        crf_tc=True, crf_tc_lambda=2e-9, crf_tc_sigma_rgb=15.0,
        crf_tc_sigma_xy=100.0, crf_tc_scale=1.0, crf_impl="exact",
        max_sizepos_tc=True, max_sizepos_tc_lambda=0.01)
    return cfg.replace(**overrides)


def stage2_tcam_production(**overrides) -> TCAMConfig:
    """Stage-2 flags of cmds/train_stage2_tcam_ytov1.sh (the production
    setting, --crf_impl landmarks with M = 1024) at batch 32 and 224 px.
    The seeder keys the script does not pass keep the hparams defaults
    (10/10 seeds, ksz 1, min_p/max_p 0.2/0.2, ROI_ALL, min size 0.05).
    Not carried: --sl_tc_knn 1 before-after and --sl_tc_knn_t (the data
    layer's CAM fusion, not ported) and --elb_max_t / --elb_mulcoef (the
    trainer's ELB anneal, not ported)."""
    cfg = TCAMConfig(
        task=constants.TCAM, batch_size=32, crop_size=224,
        encoder_name=constants.RESNET50, spatial_pooling=constants.WGAP,
        opt_name="sgd", lr=0.01, freeze_cl=True, elb_init_t=1.0,
        sl_tc=True, sl_tc_seed_tech=constants.SEED_WEIGHTED,
        sl_tc_use_roi=True,
        crf_tc=True, crf_tc_lambda=2e-9, crf_tc_sigma_rgb=15.0,
        crf_tc_sigma_xy=100.0, crf_impl="landmarks", crf_n_landmarks=1024,
        max_sizepos_tc=True, max_sizepos_tc_lambda=0.01)
    return cfg.replace(**overrides)
