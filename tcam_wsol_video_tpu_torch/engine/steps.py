"""Train / eval steps of the STD_CL, F_CL and TCAM tasks (port of
engine/steps.py: make_train_step with its student seed source,
make_cam_eval_step and make_classifier_cam_fn).

The train step, the frozen classifier's CAMs (seeds without a store, the
dump) and the eval step run their model at args.compute_dtype,
args.compute_dtype and args.eval_compute_dtype: the dtypes at which the
JAX package builds each of these models.  The losses cast to fp32 where
JAX's do (the CE, the CRF's filter inputs, the ELB); the size prior sums
the compute-dtype probabilities in their own dtype.

Batches are dicts of tensors on the step's device in the JAX layout:
image (B, H, W, 3) normalized, label (B,); for TCAM also raw_img
(B, H, W, 3) in [0, 255], std_cam (B, H, W), roi (B, H, W); optional
valid (B,), msk_bbox (B, H, W), fg_size (B,), seq_iter (B,) and
frm_iter (B,) for the losses that read them.  A compact batch
(h2d_transfer=uint8: raw_u8 in place of image and raw_img, std_cam_u16,
uint8 roi and msk_bbox) is unpacked at the head of each train step
(expand_compact_batch); the eval step takes uint8 images as well.

F_CL and TCAM share the step, as in JAX: the seeds (sl_tc or sl_fc) come
from tcam_seeder with the sl_tc_* keys, and the losses read the decoder's
maps, the raw image, the model input and the reconstruction.  The
student seed source (TCAM's sl_tc_epoch_switch_to_sl) takes the seeder's
CAMs, ROI, box mask and foreground size from the best student's own maps
(student_seed_inputs) in place of the batch's.

The throughput knobs of the JAX step: `remat` recomputes the model forward
in the backward (remat_forward); `loss_chunk` > 0 computes the F_CL/TCAM
losses over groups of that many frames (MasterLoss.compute_chunked);
`eval_transfer` uint16/uint8 packs the eval CAMs for the readback
(dequantize_cams_np unpacks them).

With a mesh of several ranks (parallel/mesh.py) the train step is the
rank's part of JAX's global step: the losses are its shares over the
dp group's global batch (MasterLoss.compute_global), the gradients are
summed over the dp group before the optimizer step, and the returned
metrics are the global batch's.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.cams.roi import roi_batch
from tcam_wsol_video_tpu_torch.cams.seeding import TCAMSeederCfg, tcam_seeder
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.data.transforms import normalize_u8_scaled
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.losses.core import LossInputs, MasterLoss
from tcam_wsol_video_tpu_torch.models.factory import DTYPES
from tcam_wsol_video_tpu_torch.models.resnet import frozen_statistics
from tcam_wsol_video_tpu_torch.ops.crf_inference import mean_field_refine
from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh


# the tasks whose steps are here: the model gives CAMs
CAM_TASKS = (constants.STD_CL, constants.F_CL, constants.TCAM)


def expand_compact_batch(batch: dict) -> dict:
    """The inverse of data/pipeline.compact_batch on the step's device:
    raw_img = raw_u8 as float32, image = (raw - 255 mean) / (255 std),
    std_cam = std_cam_u16 / 65535, roi int32 and msk_bbox float32.  A
    batch without raw_u8 is returned as it is."""
    if "raw_u8" not in batch:
        return batch
    batch = dict(batch)
    raw = batch.pop("raw_u8").to(torch.float32)
    batch["raw_img"] = raw
    batch["image"] = normalize_u8_scaled(raw)
    if "std_cam_u16" in batch:
        # uint16 as its bits in int16, widened: no uint16 arithmetic; the
        # divisor a device tensor, so that the card divides (by a Python
        # number it multiplies by the reciprocal, an ulp off)
        u16 = batch.pop("std_cam_u16").view(torch.int16).to(torch.int32)
        batch["std_cam"] = ((u16 & 0xFFFF).to(torch.float32)
                            / torch.full((), 65535.0, device=u16.device))
    if batch.get("roi") is not None and batch["roi"].dtype == torch.uint8:
        batch["roi"] = batch["roi"].to(torch.int32)
    if (batch.get("msk_bbox") is not None
            and batch["msk_bbox"].dtype == torch.uint8):
        batch["msk_bbox"] = batch["msk_bbox"].to(torch.float32)
    return batch


@torch.no_grad()
def student_seed_inputs(student, images: torch.Tensor, args,
                        dtype: torch.dtype) -> dict:
    """The seeder's inputs from the best student's maps (JAX
    steps._student_seed_inputs): the student in eval mode at `dtype`, the
    softmax foreground of its fcams, nan-guarded, min-max normalized and
    nan-guarded again -> std_cam; roi_batch(ROI_LARGEST,
    sl_tc_roi_min_size) -> roi and msk_bbox; fg_size = sum(cam roi) /
    (H W).  All on the images' device."""
    student.eval()
    cams = ex.seg_cam(student(images, dtype)["fcams"])
    cams = torch.nan_to_num(cams, nan=0.0, posinf=1.0, neginf=0.0)
    cams = torch.nan_to_num(ex.normalize_minmax(cams), nan=0.0)
    roi, msk_bbox, _ = roi_batch(cams, roi_method=constants.ROI_LARGEST,
                                 p_min_area_roi=args.sl_tc_roi_min_size)
    b, h, w = cams.shape
    fg_size = (cams * roi).reshape(b, -1).sum(-1) / float(h * w)
    return {"std_cam": cams, "roi": roi, "msk_bbox": msk_bbox,
            "fg_size": fg_size}


def remat_forward(model, images: torch.Tensor, dtype: torch.dtype,
                  dropout_generator: Optional[torch.Generator] = None
                  ) -> dict:
    """model(images, dtype, dropout_generator) under a non-reentrant
    checkpoint (JAX's jax.checkpoint around the train step's apply): the
    backward recomputes the forward instead of holding its activations.
    The recompute must be the same function, which JAX's functional state
    gives for free and torch's modules do not:
    - BatchNorm in training mode folds its batch into the running
      statistics; the recompute runs under frozen_statistics, so they are
      folded in once;
    - dropout masks come from dropout_generator, which checkpoint's
      preserve_rng_state does not restore (it restores the default
      generators, which the port never draws from): the recompute sets
      the generator back to its state before the forward, then returns it
      to where the forward left it."""
    from torch.utils.checkpoint import checkpoint
    gen = dropout_generator
    before = gen.get_state() if gen is not None else None

    @contextlib.contextmanager
    def recompute():
        after = gen.get_state() if gen is not None else None
        if gen is not None:
            gen.set_state(before)
        try:
            with frozen_statistics():
                yield
        finally:
            if gen is not None:
                gen.set_state(after)

    return checkpoint(lambda x: model(x, dtype, gen), images,
                      use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


def make_train_step(master_loss: MasterLoss, args,
                    seeder_cfg: Optional[TCAMSeederCfg] = None,
                    classifier_model=None, mesh: Optional[pmesh.Mesh] = None):
    """Returns train_step(state, batch, switches, seed_weighted,
    generator=None, gumbel=None, student=None, dropout_generator=None) ->
    metrics dict; state is updated in place (model parameters, BN
    statistics, optimizer, step).

    gumbel (B, 2, H*W) injects the seeder's fg/bg Gumbel noise; otherwise
    it is drawn from `generator`.  dropout_generator draws the masks of
    the model's dropout in training (InceptionV3's SPG blocks, WildCat's
    sorted activations); a model with live dropout raises without it.
    STD_CL takes the CE of the logits and draws no seeds (seed_weighted,
    generator and gumbel are unused).
    classifier_model, the frozen stage-1 classifier of a TCAM run without
    a CAM store: each step first recomputes batch["std_cam"] from its CAMs
    of the labels (recompute_seed_cams).  `student`, the best student's
    model (the student seed source of JAX's make_train_step): its maps
    replace the batch's seeder inputs (student_seed_inputs), and no CAMs
    are recomputed.  mesh (parallel/mesh.py, several ranks): the step is
    the rank's part of the global step, run under pmesh.use(mesh)."""
    if args.task not in CAM_TASKS:
        raise ValueError(f"no {args.task} step here (C_BOX's is "
                         "engine/cbox_steps.py)")
    std_cl = args.task == constants.STD_CL
    needs_seeds = not std_cl and bool(args.sl_tc or args.sl_fc)
    if needs_seeds and seeder_cfg is None:
        raise ValueError("seeds need a seeder config")
    if classifier_model is not None and not needs_seeds:
        raise ValueError("seed CAMs are recomputed only for seeded tasks")
    cam_fn = (make_classifier_cam_fn(classifier_model, args)
              if classifier_model is not None else None)
    dtype = DTYPES[args.compute_dtype]
    remat = bool(getattr(args, "remat", False))
    # the loss side in groups of frames, for the seeded tasks (as JAX)
    loss_chunk = 0 if std_cl else int(getattr(args, "loss_chunk", 0))

    def train_step(state: TrainState, batch, switches: Sequence[float],
                   seed_weighted: bool,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None,
                   student=None,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> dict:
        model, opt = state.model, state.optimizer
        batch = expand_compact_batch(batch)
        if student is not None:
            if not needs_seeds:
                raise ValueError("the student seed source needs seeds")
            batch = {**batch, **student_seed_inputs(student, batch["image"],
                                                    args, dtype)}
        elif cam_fn is not None:
            batch = {**batch, "std_cam": recompute_seed_cams(
                cam_fn, batch["image"], batch["label"])}
        seeds = None
        if needs_seeds:
            roi = batch["roi"] if args.sl_tc_use_roi else None
            tech = (constants.SEED_WEIGHTED
                    if (args.sl_tc_seed_tech == constants.SEED_WEIGHTED
                        and seed_weighted) else constants.SEED_UNIFORM)
            seeds = tcam_seeder(batch["std_cam"], seeder_cfg, roi=roi,
                                seed_tech=tech, generator=generator,
                                gumbel=gumbel)

        model.train()
        if remat:
            out = remat_forward(model, batch["image"], dtype,
                                dropout_generator)
        else:
            out = model(batch["image"], dtype, dropout_generator)
        logits = out["cl_logits"]
        if std_cl:
            inputs = LossInputs(epoch=state.epoch, cl_logits=logits,
                                glabel=batch["label"])
        else:
            inputs = LossInputs(epoch=state.epoch, fcams=out["fcams"],
                                cl_logits=logits, glabel=batch["label"],
                                raw_img=batch["raw_img"],
                                x_in=batch["image"],
                                im_recon=out["im_recon"], seeds=seeds,
                                seq_iter=batch.get("seq_iter"),
                                frm_iter=batch.get("frm_iter"),
                                fg_size=batch.get("fg_size"),
                                msk_bbox=batch.get("msk_bbox"))
        if mesh is not None and mesh.dp_group is not None:
            total, holder = master_loss.compute_global(
                inputs, state.elb_t, switches, mesh.dp_group, loss_chunk)
        elif loss_chunk > 0:
            total, holder = master_loss.compute_chunked(
                inputs, state.elb_t, switches, loss_chunk)
        else:
            total, holder = master_loss.compute(inputs, state.elb_t,
                                                switches)

        opt.zero_grad(set_to_none=False)
        total.backward()
        pmesh.sync_grads(model, mesh)
        opt.step()
        state.step += 1

        with torch.no_grad():
            valid = batch.get("valid")
            if valid is None:
                valid = torch.ones(logits.shape[0], dtype=torch.bool,
                                   device=logits.device)
            pred = logits.argmax(-1)
            n_correct = ((pred == batch["label"]) & valid).sum()
        return pmesh.reduce_metrics(
            {"loss": total.detach(), "n_correct": n_correct,
             "n": valid.sum(), **{k: v.detach() for k, v in holder.items()}},
            mesh)

    return pmesh.within(mesh, train_step)


def _classifier_cam(out: dict, model, images: torch.Tensor,
                    targets: torch.Tensor, args, dtype: torch.dtype,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CAM method's map of class `targets` (B, h, w) from a
    STDClassifier's forward output `out` on `images` at `dtype` (JAX
    steps._std_cam).  The gradient methods differentiate the head alone;
    SmoothGradCAM++ and the ScoreCAM family run further forwards of the
    model at `dtype`; the family scores 32 channels a forward.  Sample
    counts: args.sgcampp_num_samples / sscam_num_samples /
    iscam_num_samples, 4 / 35 / 10 when absent.  SmoothGradCAM++ and SSCAM
    draw their noise from `generator` unless `noise` is given."""
    method = args.method
    feats = out["features"][-1]
    bg = args.support_background

    def head_fn(f):
        return model.head_from_features(f)[0]

    def feats_fn(x):
        return model(x, dtype)["features"][-1]

    def logits_fn(x):
        return model(x, dtype)["cl_logits"]

    if method == constants.METHOD_CAM:
        return ex.cam_fc_weights(feats,
                                 pmesh.fc_weight(model.classification_head),
                                 targets, bg)
    if method in ex.BUILTIN_CAM_METHODS:
        return ex.builtin_cam(out["cams_head"], targets, bg)
    if method in (constants.METHOD_GRADCAM, constants.METHOD_GRADCAMPP,
                  constants.METHOD_XGRADCAM, constants.METHOD_LAYERCAM):
        return ex.build_std_extractor(method)(head_fn, feats, targets)
    if method == constants.METHOD_SMOOTHGRADCAMPP:
        return ex.smooth_grad_cam_pp(
            feats_fn, head_fn, images, targets, generator,
            num_samples=int(getattr(args, "sgcampp_num_samples", 4)),
            noise=noise)
    if method == constants.METHOD_SCORECAM:
        return ex.score_cam(logits_fn, images, feats, targets)
    if method == constants.METHOD_SSCAM:
        return ex.sscam(logits_fn, images, feats, targets, generator,
                        num_samples=int(getattr(args, "sscam_num_samples",
                                                35)), noise=noise)
    if method == constants.METHOD_ISCAM:
        return ex.iscam(logits_fn, images, feats, targets,
                        num_samples=int(getattr(args, "iscam_num_samples",
                                                10)))
    raise ValueError(f"unknown CAM method {method!r}")


def make_cam_eval_step(model, args):
    """Returns eval_step(images, raw_images=None, targets=None,
    generator=None, noise=None) -> (cams (B, crop, crop) in [0, 1],
    cl_logits).  uint8 images (h2d_transfer=uint8) are normalized as
    expand_compact_batch does, and serve as raw_images when those are not
    given.  F_CL and TCAM: the softmax foreground of the decoder output;
    STD_CL: the CAM method's map of class `targets` (the labels,
    _classifier_cam; `generator` or `noise` for the methods that draw
    noise).  Then nan-guarded, resized to the crop
    (align_corners=False) and clipped.  With args.crf_post_process and
    raw_images (B, crop, crop, 3) in [0, 255], the CAM is then refined by
    crf_pp_iters mean-field iterations.  args.eval_transfer packs the CAMs
    for the readback as JAX's step does: uint16 holds floor(cam 255) 257
    (the box protocol's uint8 grid, which /65535 gives back exactly),
    uint8 floor(cam 255) (the protocol's own truncation); float32 returns
    them as they are.  dequantize_cams_np unpacks them on the host."""
    if args.task not in CAM_TASKS:
        raise ValueError(f"no {args.task} eval step here (C_BOX's is "
                         "engine/cbox_steps.py)")
    std_cl = args.task == constants.STD_CL
    crop = args.crop_size
    use_crf_pp = bool(args.crf_post_process)
    dtype = DTYPES[args.eval_compute_dtype]
    transfer = str(getattr(args, "eval_transfer", "float32"))
    box_protocol = args.dataset != constants.OpenImages

    @torch.no_grad()
    def eval_step(images: torch.Tensor,
                  raw_images: Optional[torch.Tensor] = None,
                  targets: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
        model.eval()
        if images.dtype == torch.uint8:
            raw = images.to(torch.float32)
            images = normalize_u8_scaled(raw)
            if raw_images is None:
                raw_images = raw
        out = model(images, dtype)
        if std_cl:
            cam = _classifier_cam(out, model, images, targets, args, dtype,
                                  generator, noise)
        else:
            cam = ex.seg_cam(out["fcams"])
        cam = torch.nan_to_num(cam.float(), nan=0.0, posinf=1.0, neginf=0.0)
        if tuple(cam.shape[-2:]) != (crop, crop):
            cam = resize_bilinear(cam[..., None], (crop, crop),
                                  align_corners=False)[..., 0]
        cam = cam.clamp(0.0, 1.0)
        if use_crf_pp and raw_images is not None:
            probs = torch.stack([1.0 - cam, cam], dim=-1)
            cam = mean_field_refine(raw_images, probs,
                                    num_iters=args.crf_pp_iters)[..., 1]
            cam = torch.nan_to_num(cam).clamp(0.0, 1.0)
        return pack_cams(cam, transfer, box_protocol), out["cl_logits"]

    return eval_step


def pack_cams(cam: torch.Tensor, transfer: str,
              box_protocol: bool = True) -> torch.Tensor:
    """CAMs in [0, 1] in the eval_transfer dtype (JAX make_cam_eval_step's
    tail): uint16 round(floor(cam 255) / 255 65535) for the box protocol,
    round(cam 65535) for PxAP (OpenImages, which reads the float CAM),
    uint8 floor(cam 255), float32 unchanged."""
    if transfer == "uint16":
        if box_protocol:
            cam = torch.floor(cam * 255.0) / 255.0
        return torch.round(cam * 65535.0).to(torch.int32).to(torch.uint16)
    if transfer == "uint8":
        return torch.floor(cam * 255.0).to(torch.uint8)
    return cam


def dequantize_cams_np(cams_np: np.ndarray) -> np.ndarray:
    """The inverse of pack_cams after the readback (JAX
    dequantize_cams_np): uint16 -> /65535, uint8 -> /255 (both exact on
    the uint8 grid), float32 as it is."""
    if cams_np.dtype == np.uint16:
        return cams_np.astype(np.float32) / 65535.0
    if cams_np.dtype == np.uint8:
        return cams_np.astype(np.float32) / 255.0
    return cams_np


def make_classifier_cam_fn(classifier_model, args):
    """Returns cam_fn(images, targets) -> (B, h, w) CAMs of the frozen
    stage-1 classifier at its last feature's resolution, nan-guarded (the
    CAM store's dump, and seeds recomputed without a store).  A head that
    builds maps (GAP, MaxPool, LSE, WildCat) gives its map of the target
    class (JAX's built-in route); WGAP the fc-weight CAM, which the JAX
    step recomputes its seeds with whatever the method.  The classifier
    runs at args.compute_dtype; its features times the fp32 fc weights
    give fp32 CAMs, and a head's maps are normalized in their own dtype
    and returned as fp32."""
    dtype = DTYPES[args.compute_dtype]
    builtin = classifier_model.classification_head.builtin_cam

    @torch.no_grad()
    def cam_fn(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        classifier_model.eval()
        out = classifier_model(images, dtype)
        if builtin:
            cam = ex.builtin_cam(out["cams_head"], targets,
                                 args.support_background)
        else:
            cam = ex.cam_fc_weights(
                out["features"][-1],
                classifier_model.classification_head.fc.weight, targets,
                args.support_background)
        return torch.nan_to_num(cam, nan=0.0, posinf=1.0,
                                neginf=0.0).float()

    return cam_fn


@torch.no_grad()
def recompute_seed_cams(cam_fn, images: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """The seeder's CAMs without a CAM store (JAX engine/steps.py
    train_step, recompute_std_cams): the frozen classifier's CAMs of the
    labels, resized to the crop of images (B, H, W, 3) with
    align_corners=False when their size differs, clipped to [0, 1]."""
    cams = cam_fn(images, labels)
    if tuple(cams.shape[-2:]) != tuple(images.shape[1:3]):
        cams = resize_bilinear(cams[..., None], tuple(images.shape[1:3]),
                               align_corners=False)[..., 0]
    return cams.clamp(0.0, 1.0)
