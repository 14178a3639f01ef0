"""The hparams keys of the ported slices, and their command line.

Names and defaults are those of the JAX package's core/hparams.py
`get_config` (YouTube-Objects-v1.0 defaults), so a recipe written for one
package reads the same in the other, and `parse_args` takes the same
`--key value` flags (booleans as true/false, lists as [a, b]).  The
full hparams port (--config yaml files, every task's keys) is later work.
`stage1_cam_recipe` gives the stage-1 classifier of
config_yaml/ytov1_stage1_cam.yaml, `stage2_tcam_recipe` the stage-2 step
flags of the end-to-end script, `stage2_tcam_production` those of the
production stage-2 script (landmark CRF).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from tcam_wsol_video_tpu_torch.core import constants

# the choices of compute_dtype and eval_compute_dtype (the JAX model
# factory's table), and of h2d_transfer
COMPUTE_DTYPES = ("float32", "bfloat16")
H2D_TRANSFERS = ("float32", "uint8")


def get_root_datasets_dir() -> str:
    return os.environ.get("TCAM_TPU_DATA_ROOT",
                          os.path.expanduser("~/datasets"))


@dataclass
class TCAMConfig:
    # experiment
    dataset: str = constants.YTOV1
    num_classes: int = constants.NUMBER_CLASSES[constants.YTOV1]
    crop_size: int = constants.CROP_SIZE
    resize_size: int = constants.RESIZE_SIZE
    batch_size: int = 32
    eval_batch_size: int = 64
    max_epochs: int = 150
    seed: int = 0
    exp_id: str = "exp"
    outd: str = "exps"
    data_root: str = field(default_factory=get_root_datasets_dir)
    metadata_root: str = constants.RELATIVE_META_ROOT
    std_cams_folder: str = ""
    num_workers: int = 4        # accepted; the image loaders use OpenMP
    proxy_training_set: bool = False
    num_val_sample_per_class: int = 0
    checkpoint_save: int = 100
    keep_last_n_checkpoints: int = 1
    log_every: int = 10
    # the train data plane (data/pipeline.py, data/device_feed.py):
    # uint8 pixels and packed CAM/ROI planes over host -> device, the
    # decoded-frame cache budget (MiB; 0 = off) and the card-resident
    # train feed's frames-pool budget (MiB; 0 = off)
    h2d_transfer: str = "float32"
    decode_cache_mb: int = 0
    train_device_cache_mb: int = 0
    # dtype policy: fp32 parameters; the train step, the dump and the
    # frozen seeder classifier compute in compute_dtype, evaluation in
    # eval_compute_dtype (models/factory.py DTYPES)
    compute_dtype: str = "bfloat16"
    eval_compute_dtype: str = "float32"
    # eval
    cam_curve_interval: float = 0.001
    multi_contour_eval: bool = True
    multi_iou_eval: bool = True
    iou_threshold_list: List[int] = field(
        default_factory=lambda: [30, 50, 70])
    box_v2_metric: bool = True
    eval_checkpoint_type: str = constants.BEST_LOC
    fast_eval: bool = True
    # model
    task: str = constants.STD_CL
    arch: str = constants.STDCLASSIFIER
    method: str = constants.METHOD_CAM
    encoder_name: str = constants.RESNET50
    spatial_pooling: str = constants.WGAP
    freeze_cl: bool = False
    # the classifier's CAM of class label + 1 (a background class at 0)
    support_background: bool = False
    folder_pre_trained_cl: str = ""
    # stage-1 snapshots: the classifier that stage 2 starts from, and the
    # one whose CAMs seed it
    tcam_pretrained_cl_ch_pt: str = constants.BEST_CL
    tcam_pretrained_seeder_ch_pt: str = constants.BEST_LOC
    seg_ignore_idx: int = constants.SEG_IGNORE_IDX
    # optimizer
    opt_name: str = "sgd"
    lr: float = 0.001
    momentum: float = 0.9
    dampening: float = 0.0
    weight_decay: float = 1e-4
    nesterov: bool = True
    lr_scheduler: str = "mystep"
    step_size: int = 5
    gamma: float = 0.1
    min_lr: float = 1e-7
    t_max: int = 50
    lr_coef: float = 0.5
    lr_milestones: List[int] = field(default_factory=lambda: [30, 60])
    lr_classifier_ratio: float = 10.0
    # ELB
    elb_init_t: float = 1.0
    elb_max_t: float = 10.0
    elb_mulcoef: float = 1.01
    # image reconstruction (not ported; read only to refuse it)
    im_rec: bool = False
    # clip sampling: knn_tc > 0 makes batches of clips of 2 knn_tc + 1
    # frames (the temporal joint CRF's layout)
    knn_tc: int = 0
    # temporal fusion of the stored CAMs (DecayTemp)
    sl_tc_knn: int = 0
    sl_tc_knn_mode: str = constants.TIME_INSTANT
    sl_tc_knn_t: float = 0.0
    sl_tc_knn_epoch_switch_uniform: int = -1
    sl_tc_min_t: float = 0.0
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


def stage1_cam_recipe(**overrides) -> TCAMConfig:
    """config_yaml/ytov1_stage1_cam.yaml: the STD_CL classifier (ResNet-50,
    WGAP head, CAM method), SGD at lr 0.001, batch 32, 100 epochs."""
    cfg = TCAMConfig(
        task=constants.STD_CL, arch=constants.STDCLASSIFIER,
        encoder_name=constants.RESNET50, method=constants.METHOD_CAM,
        spatial_pooling=constants.WGAP, opt_name="sgd", lr=0.001,
        batch_size=32, max_epochs=100)
    return cfg.replace(**overrides)


def stage2_tcam_recipe(**overrides) -> TCAMConfig:
    """Stage-2 step flags of cmds/e2e_synth224_tpu.sh with the batch size
    and freeze_cl of config_yaml/ytov1_stage2_tcam.yaml (the data-layer and
    trainer flags of the script go through cli/train.py)."""
    cfg = TCAMConfig(
        task=constants.TCAM, arch=constants.UNETTCAM, batch_size=32,
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
    The script's paths (stage-1 folder, CAM store) are the caller's."""
    cfg = TCAMConfig(
        task=constants.TCAM, arch=constants.UNETTCAM, batch_size=32,
        crop_size=224, max_epochs=100, sl_tc_knn=1,
        sl_tc_knn_mode=constants.TIME_BEFORE_AFTER, sl_tc_knn_t=1.0,
        elb_max_t=10.0, elb_mulcoef=1.01,
        encoder_name=constants.RESNET50, spatial_pooling=constants.WGAP,
        opt_name="sgd", lr=0.01, freeze_cl=True, elb_init_t=1.0,
        sl_tc=True, sl_tc_seed_tech=constants.SEED_WEIGHTED,
        sl_tc_use_roi=True,
        crf_tc=True, crf_tc_lambda=2e-9, crf_tc_sigma_rgb=15.0,
        crf_tc_sigma_xy=100.0, crf_impl="landmarks", crf_n_landmarks=1024,
        max_sizepos_tc=True, max_sizepos_tc_lambda=0.01)
    return cfg.replace(**overrides)


_TRUE = {"1", "true", "yes", "y", "t"}


def _coerce(default, text: str):
    """A command-line string as the type of the key's default."""
    if isinstance(default, bool):
        return text.lower() in _TRUE
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    if isinstance(default, list):
        value = json.loads(text)
        if not isinstance(value, list):
            raise ValueError(f"expected a list like [30, 50, 70]: {text!r}")
        return value
    return text


def experiment_tag(args) -> str:
    """The experiment folder's name, as the JAX package builds it.  The
    task is not part of it: both stages of a recipe share one tag."""
    return (f"{args.dataset}-{args.encoder_name}-{args.method}-"
            f"{args.spatial_pooling}-cp_{args.eval_checkpoint_type}-"
            f"boxv2_{args.box_v2_metric}")


def finalize(args: TCAMConfig) -> TCAMConfig:
    """Cross-key checks of the ported tasks, and the clip batch split."""
    if args.dataset not in constants.NUMBER_CLASSES:
        raise ValueError(f"dataset {args.dataset!r} is not ported")
    if args.spatial_pooling not in constants.SPATIAL_POOLINGS:
        raise ValueError(f"spatial_pooling {args.spatial_pooling!r}")
    for key in ("compute_dtype", "eval_compute_dtype"):
        if getattr(args, key) not in COMPUTE_DTYPES:
            raise ValueError(f"{key} must be one of {COMPUTE_DTYPES}, got "
                             f"{getattr(args, key)!r}")
    if args.task == constants.STD_CL:
        if args.arch != constants.STDCLASSIFIER:
            raise ValueError("STD_CL trains the STDClassifier arch")
        # the method fixes the pooling head (METHOD_2_POOLINGHEAD); only
        # the CAM method and its WGAP head are ported
        if args.method != constants.METHOD_CAM:
            raise NotImplementedError(f"CAM method {args.method} is not "
                                      "ported")
        if args.spatial_pooling != constants.WGAP:
            raise NotImplementedError(f"pooling head {args.spatial_pooling}"
                                      " is not ported")
    if args.task == constants.TCAM:
        if args.arch != constants.UNETTCAM:
            raise ValueError("TCAM trains the UnetTCAM arch")
        if args.dataset not in constants.VIDEO_DATASETS:
            raise ValueError("TCAM needs a video dataset")
    if args.sl_tc_knn_mode not in constants.TIME_DEPENDENCY:
        raise ValueError(f"sl_tc_knn_mode {args.sl_tc_knn_mode!r}")
    if args.sl_tc_knn_mode == constants.TIME_INSTANT and args.sl_tc_knn:
        raise ValueError("sl_tc_knn > 0 needs a sl_tc_knn_mode other than "
                         "instant")
    if args.sl_tc_seed_tech not in constants.SEED_TECHS:
        raise ValueError(f"sl_tc_seed_tech {args.sl_tc_seed_tech!r}")
    if args.sl_tc_roi_method not in constants.ROI_SELECT:
        raise ValueError(f"sl_tc_roi_method {args.sl_tc_roi_method!r}")
    if args.h2d_transfer not in H2D_TRANSFERS:
        raise ValueError(f"h2d_transfer must be one of {H2D_TRANSFERS}, "
                         f"got {args.h2d_transfer!r}")
    # a batch of B shots expands to B (2 knn_tc + 1) frames
    if args.task == constants.TCAM and args.knn_tc > 0:
        args = args.replace(
            batch_size=max(1, args.batch_size // (2 * args.knn_tc + 1)))
    return args


def parse_args(argv: Optional[Sequence[str]] = None,
               extra: Optional[argparse.ArgumentParser] = None):
    """`--key value` for every TCAMConfig key -> (finalized config,
    namespace of `extra`'s own arguments)."""
    base = TCAMConfig()
    parser = argparse.ArgumentParser(
        parents=[extra] if extra is not None else [],
        description="tcam_wsol_video_tpu_torch")
    for f in dataclasses.fields(TCAMConfig):
        parser.add_argument(f"--{f.name}", type=str, default=None)
    ns = parser.parse_args(argv)
    values = {f.name: _coerce(getattr(base, f.name), getattr(ns, f.name))
              for f in dataclasses.fields(TCAMConfig)
              if getattr(ns, f.name) is not None}
    return finalize(base.replace(**values)), ns
