"""The hparams keys of the ported slices, and their command line.

Names and defaults are those of the JAX package's core/hparams.py
`get_config` (YouTube-Objects-v1.0 defaults), so a recipe written for one
package reads the same in the other, and `parse_args` takes the same
command line: `--key value` flags (booleans as true/false, lists as
[a, b]), `--config <yaml>` applied before them, and the reference's
spellings (`--opt__*` aliases, runtime flags dropped with a warning).
The keys of modules not ported yet (the demo and visuals, the image
datasets) are absent: a flag or a yaml key naming one is refused.
The keys that JAX parses and never reads (UNREAD_KEYS) are accepted at
their defaults only: any other value raises, so that setting one cannot
seem to change a run.
`stage1_cam_recipe` gives the stage-1 classifier of
config_yaml/ytov1_stage1_cam.yaml, `stage2_tcam_recipe` the
stage-2 step flags of the end-to-end script, `stage2_tcam_production`
those of the production stage-2 script (landmark CRF).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.data.folds import (parse_flat_mapping,
                                                  parse_scalar)

# the choices of compute_dtype and eval_compute_dtype (the JAX model
# factory's table), and of h2d_transfer
COMPUTE_DTYPES = ("float32", "bfloat16")
H2D_TRANSFERS = ("float32", "uint8")
# the choices of eval_transfer and eval_sweep (JAX hparams.finalize)
EVAL_TRANSFERS = ("float32", "uint16", "uint8")
EVAL_SWEEPS = ("auto", "device", "host")
# the tasks of the JAX package (its SEG task is vestigial there)
PORTED_TASKS = (constants.STD_CL, constants.F_CL, constants.TCAM,
                constants.C_BOX)
# the keys that the JAX package parses and no module of either package
# reads: finalize accepts each at its default only
UNREAD_KEYS = ("encoder_weights", "in_channels", "scale_in",
               "path_pre_trained", "strict", "seg_mode", "save_dir_models",
               "cb_pretrained_cl_ch_pt", "cb_area_normed", "cb_pp_box_alpha",
               "cb_seed_bg_z_type")
# the encoders that JAX's models/factory.get_encoder builds
ENCODER_NAMES = (constants.RESNET50, "resnet101", constants.VGG16,
                 constants.INCEPTIONV3)


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
    save_dir_models: str = ""   # UNREAD_KEYS
    # the train data plane (data/pipeline.py, data/device_feed.py):
    # uint8 pixels and packed CAM/ROI planes over host -> device, the
    # decoded-frame cache budget (MiB; 0 = off) and the card-resident
    # train feed's frames-pool budget (MiB; 0 = off)
    h2d_transfer: str = "float32"
    decode_cache_mb: int = 0
    train_device_cache_mb: int = 0
    # the throughput layer: K train steps a dispatch over the card-resident
    # feed (engine/scan_train.py; 0 = one step a dispatch), the loss side
    # in groups of loss_chunk frames (0 = off) and the model forward
    # recomputed in the backward (remat)
    train_dispatch_chunk: int = 8
    loss_chunk: int = 0
    remat: bool = False
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
    # the eval knobs (engine/evaluator.py): the approximate covering-box
    # counters on the device (model selection only), the CAMs' readback
    # dtype, where the exact sweep runs, batches in flight, and the
    # card-resident cache of prepared eval batches with its budget (MiB)
    on_device_eval: bool = False
    eval_transfer: str = "float32"
    eval_sweep: str = "auto"
    eval_pipeline_depth: int = 8
    eval_device_cache: bool = False
    eval_device_cache_mb: int = 1024
    # model
    task: str = constants.STD_CL
    arch: str = constants.STDCLASSIFIER
    method: str = constants.METHOD_CAM
    encoder_name: str = constants.RESNET50
    spatial_pooling: str = constants.WGAP
    # pooling-head hyperparameters: the LSE head's r; WildCat's modalities
    # per class, kmax and kmin (an int counts maps, a float in (0, 1) is a
    # share of them and a float 1.0 all of them), alpha and the dropout on
    # its sorted activations
    lse_r: float = 10.0
    wc_modalities: int = 5
    wc_kmax: float = 0.5
    wc_kmin: Optional[float] = None
    wc_alpha: float = 0.6
    wc_dropout: float = 0.0
    freeze_cl: bool = False
    # UNREAD_KEYS (scale_in reaches no computation in JAX either)
    encoder_weights: str = "imagenet"
    in_channels: int = 3
    scale_in: float = 1.0
    path_pre_trained: str = ""
    strict: bool = True
    seg_mode: str = constants.BINARY_MODE
    multi_label_flag: bool = False
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
    # image reconstruction: a head on the decoder's output in
    # [0, img_range], trained by the MSE to the network input (or an ELB
    # over it)
    img_range: float = 1.0
    im_rec: bool = False
    im_rec_lambda: float = 1.0
    im_rec_elb: bool = False
    # clip sampling: knn_tc > 0 makes batches of clips of 2 knn_tc + 1
    # frames (the temporal joint CRF's layout)
    knn_tc: int = 0
    # temporal fusion of the stored CAMs (DecayTemp)
    sl_tc_knn: int = 0
    sl_tc_knn_mode: str = constants.TIME_INSTANT
    sl_tc_knn_t: float = 0.0
    sl_tc_knn_epoch_switch_uniform: int = -1
    sl_tc_min_t: float = 0.0
    # from this epoch (-1: never) the seeds come from the best student's
    # own CAMs (its best-localization snapshot) in place of the stored
    # ones
    sl_tc_epoch_switch_to_sl: int = -1
    # self-learning seeds
    sl_tc: bool = False
    sl_tc_lambda: float = 1.0
    sl_tc_start_ep: int = 0
    sl_tc_end_ep: int = -1
    sl_tc_min: int = 10
    sl_tc_max: int = 10
    sl_tc_block: int = 1        # accepted; seeds are per pixel (1 only)
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
    # F_CL (F-CAM): self-learning CE, dense CRF, entropy and the ELB size
    # prior on the UnetFCAM's maps; its seeds come from the sl_tc_*
    # seeder, as in the JAX step
    sl_fc: bool = False
    sl_fc_lambda: float = 1.0
    sl_start_ep: int = 0
    sl_end_ep: int = -1
    sl_min: int = 10
    sl_max: int = 10
    sl_block: int = 1           # accepted; seeds are per pixel (1 only)
    sl_ksz: int = 1
    sl_min_p: float = 0.2
    sl_fg_erode_k: int = 11
    sl_fg_erode_iter: int = 1
    crf_fc: bool = False
    crf_lambda: float = 2e-9
    crf_sigma_rgb: float = 15.0
    crf_sigma_xy: float = 100.0
    crf_scale: float = 1.0
    crf_start_ep: int = 0
    crf_end_ep: int = -1
    entropy_fc: bool = False
    entropy_fc_lambda: float = 1.0
    max_sizepos_fc: bool = False
    max_sizepos_fc_lambda: float = 1.0
    max_sizepos_fc_start_ep: int = 0
    max_sizepos_fc_end_ep: int = -1
    # C_BOX (DenseBoxNet): ELB on the box's area (AreaBox) and on the
    # frozen classifier's scores of the fg/bg composites (ClScoring, the
    # background a Gaussian blur of ksize / sigma), the CE of the box's
    # masks against seeds from the CAM store (SeedCbox), and the smooth-L1
    # pull towards the pre-forward's box (BoxBounds), which replaces a box
    # that is invalid or under the minimum size (per class from the val
    # GT, or cb_pp_box_min_size) by a centred one of area ~ N(size, var)
    cb_pretrained_cl_ch_pt: str = constants.BEST_CL  # UNREAD_KEYS
    cb_area_box: bool = False
    cb_area_box_l: float = 1.0
    cb_area_normed: bool = False    # UNREAD_KEYS: the step never sets it
    cb_area_box_start_epoch: int = 0
    cb_area_box_end_epoch: int = -1
    cb_cl_score: bool = False
    cb_cl_score_l: float = 1.0
    cb_cl_score_start_epoch: int = 0
    cb_cl_score_end_epoch: int = -1
    cb_cl_score_blur_ksize: int = 65
    cb_cl_score_blur_sigma: float = 60.0
    cb_pp_box: bool = False
    cb_pp_box_l: float = 1.0
    cb_pp_box_start_epoch: int = 0
    cb_pp_box_end_epoch: int = -1
    cb_pp_box_alpha: float = 0.1    # UNREAD_KEYS
    cb_pp_box_min_size_type: str = constants.SIZE_DATA
    cb_pp_box_min_size: float = 0.05
    cb_seed: bool = False
    cb_seed_l: float = 1.0
    cb_seed_start_epoch: int = 0
    cb_seed_end_epoch: int = -1
    cb_seed_erode_k: int = 11
    cb_seed_erode_iter: int = 1
    cb_seed_ksz: int = 3
    cb_seed_n: int = 1
    cb_seed_bg_low_z: float = 0.3
    cb_seed_bg_up_z: float = 0.4
    cb_seed_bg_z_type: str = constants.SIZE_DATA  # UNREAD_KEYS
    cb_init_box_size: float = 0.95
    cb_init_box_var: float = 0.015
    cb_scale_domain: float = 1.0
    # DenseBoxNet's encoder in eval mode and without gradient
    freeze_encoder: bool = False
    # the process mesh (parallel/mesh.py): dp shards the batch over the
    # ranks (-1: world // mesh_mp), mp shards the head's fc over classes
    mesh_dp: int = -1
    mesh_mp: int = 1

    def replace(self, **kw) -> "TCAMConfig":
        return dataclasses.replace(self, **kw)

    @property
    def std_cl_method_requires_grad(self) -> bool:
        """Whether the CAM method differentiates the head at eval time
        (JAX's hparams.finalize sets the same key)."""
        return constants.METHOD_REQU_GRAD[self.method]


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
    """A command-line string as the type of the key's current value (its
    default, or the --config yaml's value)."""
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
    if default is None:
        try:
            return parse_scalar(text)
        except ValueError:
            return text
    return text


# the reference's flag names -> the config's keys, so its published
# commands paste in unchanged (the JAX package's core/hparams.py)
REFERENCE_ALIASES = {
    "opt__name_optimizer": "opt_name",
    "opt__lr": "lr",
    "opt__momentum": "momentum",
    "opt__dampening": "dampening",
    "opt__nesterov": "nesterov",
    "opt__weight_decay": "weight_decay",
    "opt__name_lr_scheduler": "lr_scheduler",
    "opt__gamma": "gamma",
    "opt__min_lr": "min_lr",
    "opt__t_max": "t_max",
    "opt__step_size": "step_size",
    "opt__lr_classifier_ratio": "lr_classifier_ratio",
}
# the reference's runtime flags (distributed launch, device ids, AMP) and
# its adam-only keys: accepted and dropped with a warning
REFERENCE_IGNORED = {
    "local_world_size", "local_rank", "dist_backend", "cudaid",
    "c_cudaid", "world_size", "amp", "amp_eval",
    "opt__beta1", "opt__beta2", "opt__eps_adam", "opt__amsgrad",
    "opt__last_epoch",
}


def normalize_reference_argv(argv: Sequence[str]) -> List[str]:
    """argv with the reference's spellings rewritten: aliases renamed,
    runtime flags dropped (with a warning), `--opt__lr_scheduler False`
    -> `--lr_scheduler constant`."""
    out, dropped, i = [], [], 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            out.append(tok)
            i += 1
            continue
        name, eq, inline = tok[2:].partition("=")
        inline_val = inline if eq else None
        has_sep_val = (inline_val is None and i + 1 < len(argv)
                       and not argv[i + 1].startswith("--"))
        if name in REFERENCE_IGNORED:
            dropped.append(name)
            i += 2 if has_sep_val else 1
            continue
        if name == "opt__lr_scheduler":
            val = inline_val if inline_val is not None else (
                argv[i + 1] if has_sep_val else "true")
            if val.lower() not in _TRUE:
                out += ["--lr_scheduler", "constant"]
            i += 2 if has_sep_val else 1
            continue
        if name in REFERENCE_ALIASES:
            new = REFERENCE_ALIASES[name]
            out.append(f"--{new}={inline_val}" if inline_val is not None
                       else f"--{new}")
        else:
            out.append(tok)
        i += 1
    if dropped:
        warnings.warn(
            "reference runtime flags accepted and ignored: "
            f"{sorted(set(dropped))}", stacklevel=3)
    return out


def read_config_yaml(path: str) -> dict:
    """A recipe yaml (a flat mapping of scalars) typed as PyYAML's
    safe_load types it; a key the config lacks raises."""
    with open(path) as f:
        values = parse_flat_mapping(f.read())
    keys = {f.name for f in dataclasses.fields(TCAMConfig)}
    unknown = sorted(str(k) for k in values if k not in keys)
    if unknown:
        raise ValueError(f"{path}: keys of modules not ported: {unknown}")
    return values


def experiment_tag(args) -> str:
    """The experiment folder's name, as the JAX package builds it.  The
    task is not part of it: both stages of a recipe share one tag."""
    return (f"{args.dataset}-{args.encoder_name}-{args.method}-"
            f"{args.spatial_pooling}-cp_{args.eval_checkpoint_type}-"
            f"boxv2_{args.box_v2_metric}")


def finalize(args: TCAMConfig) -> TCAMConfig:
    """Cross-key checks of the ported tasks, and the clip batch split."""
    defaults = TCAMConfig()
    for key in UNREAD_KEYS:
        if getattr(args, key) != getattr(defaults, key):
            raise ValueError(
                f"{key} is read by no module (nor in the JAX package): only "
                f"its default {getattr(defaults, key)!r} is accepted, got "
                f"{getattr(args, key)!r}")
    if args.dataset not in constants.NUMBER_CLASSES:
        raise ValueError(f"dataset {args.dataset!r} is not ported")
    if args.spatial_pooling not in constants.SPATIAL_POOLINGS:
        raise ValueError(f"spatial_pooling {args.spatial_pooling!r}")
    if args.encoder_name not in ENCODER_NAMES:
        raise ValueError(f"encoder_name must be one of {ENCODER_NAMES}, "
                         f"got {args.encoder_name!r}")
    if args.method not in constants.CAM_METHODS:
        raise ValueError(f"method must be one of {constants.CAM_METHODS}, "
                         f"got {args.method!r}")
    for key in ("compute_dtype", "eval_compute_dtype"):
        if getattr(args, key) not in COMPUTE_DTYPES:
            raise ValueError(f"{key} must be one of {COMPUTE_DTYPES}, got "
                             f"{getattr(args, key)!r}")
    if args.task == constants.STD_CL:
        if args.arch != constants.STDCLASSIFIER:
            raise ValueError("STD_CL trains the STDClassifier arch")
        # the method fixes the pooling head
        want = constants.METHOD_2_POOLINGHEAD[args.method]
        if args.spatial_pooling != want:
            raise ValueError(f"method {args.method} requires pooling {want}"
                             f", got {args.spatial_pooling}")
    if args.task == constants.TCAM:
        if args.arch != constants.UNETTCAM:
            raise ValueError("TCAM trains the UnetTCAM arch")
        if args.dataset not in constants.VIDEO_DATASETS:
            raise ValueError("TCAM needs a video dataset")
    if args.task == constants.F_CL and args.arch != constants.UNETFCAM:
        raise ValueError("F_CL trains the UnetFCAM arch")
    if args.task == constants.C_BOX:
        _check_cbox(args)
    if args.task not in PORTED_TASKS:
        raise NotImplementedError(f"task {args.task} is not ported")
    # as upstream, seeds are drawn per pixel: block seeding is a no-op
    if args.sl_block != 1 or args.sl_tc_block != 1:
        raise ValueError("only sl_block = sl_tc_block = 1 is supported")
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
    if args.eval_transfer not in EVAL_TRANSFERS:
        raise ValueError(f"eval_transfer must be one of {EVAL_TRANSFERS}, "
                         f"got {args.eval_transfer!r}")
    if args.mesh_mp < 1 or (args.mesh_dp != -1 and args.mesh_dp < 1):
        raise ValueError(f"mesh_dp must be -1 or >= 1 and mesh_mp >= 1, got "
                         f"{args.mesh_dp} x {args.mesh_mp}")
    if args.eval_sweep not in EVAL_SWEEPS:
        raise ValueError(f"eval_sweep must be one of {EVAL_SWEEPS}, got "
                         f"{args.eval_sweep!r}")
    # a batch of B shots expands to B (2 knn_tc + 1) frames
    if args.task == constants.TCAM and args.knn_tc > 0:
        args = args.replace(
            batch_size=max(1, args.batch_size // (2 * args.knn_tc + 1)))
    return args


def _check_cbox(args: TCAMConfig) -> None:
    """JAX hparams.finalize's C_BOX checks."""
    if args.arch != constants.DENSEBOXNET:
        raise ValueError("C_BOX trains the DenseBoxNet arch")
    if args.cb_pp_box_min_size_type not in constants.SIZE_TYPES:
        raise ValueError("cb_pp_box_min_size_type must be one of "
                         f"{constants.SIZE_TYPES}, got "
                         f"{args.cb_pp_box_min_size_type!r}")
    if args.cb_cl_score_blur_ksize % 2 != 1:
        raise ValueError("cb_cl_score_blur_ksize must be odd")
    if not 0.0 <= args.cb_seed_bg_low_z <= args.cb_seed_bg_up_z <= 1.0:
        raise ValueError("need 0 <= cb_seed_bg_low_z <= cb_seed_bg_up_z "
                         "<= 1")
    if not 0.0 < args.cb_init_box_size <= 1.0:
        raise ValueError("cb_init_box_size must lie in (0, 1]")
    if args.cb_init_box_var < 0.0:
        raise ValueError("cb_init_box_var must be >= 0")
    if args.cb_seed_n < 1:
        raise ValueError("cb_seed_n must be >= 1")


def parse_args(argv: Optional[Sequence[str]] = None,
               extra: Optional[argparse.ArgumentParser] = None):
    """The JAX CLI's command line -> (finalized config, namespace of
    `extra`'s own arguments).  As there: the reference's spellings are
    normalized first; --dataset picks the defaults; the --config yaml's
    values replace them as they are (typed as safe_load types them);
    then each `--key value` flag is coerced to the type of the key's value
    so far."""
    import sys
    argv = normalize_reference_argv(sys.argv[1:] if argv is None else argv)
    boot = argparse.ArgumentParser(add_help=False)
    boot.add_argument("--dataset", type=str, default=constants.YTOV1)
    boot.add_argument("--config", type=str, default="",
                      help="optional yaml file applied before the flags")
    ns_boot, rest = boot.parse_known_args(argv)
    if ns_boot.dataset not in constants.NUMBER_CLASSES:
        raise ValueError(f"dataset {ns_boot.dataset!r} is not ported")
    base = TCAMConfig(dataset=ns_boot.dataset,
                      num_classes=constants.NUMBER_CLASSES[ns_boot.dataset])
    if ns_boot.config:
        base = base.replace(**read_config_yaml(ns_boot.config))

    parser = argparse.ArgumentParser(
        parents=[extra] if extra is not None else [],
        description="tcam_wsol_video_tpu_torch")
    for f in dataclasses.fields(TCAMConfig):
        if f.name != "dataset":
            parser.add_argument(f"--{f.name}", type=str, default=None)
    ns = parser.parse_args(rest)
    values = {f.name: _coerce(getattr(base, f.name), getattr(ns, f.name))
              for f in dataclasses.fields(TCAMConfig)
              if f.name != "dataset" and getattr(ns, f.name) is not None}
    return finalize(base.replace(**values)), ns
