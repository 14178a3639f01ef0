"""Train / eval steps of the TCAM task (port of engine/steps.py, TCAM
branches of make_train_step and make_cam_eval_step).

Batches are dicts of tensors on the step's device in the JAX layout:
image (B, H, W, 3) normalized, label (B,), raw_img (B, H, W, 3) in
[0, 255], std_cam (B, H, W), roi (B, H, W); optional valid (B,),
msk_bbox (B, H, W), fg_size (B,), seq_iter (B,) and frm_iter (B,) for
the losses that read them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from tcam_wsol_video_tpu_torch.cams import extractors as ex
from tcam_wsol_video_tpu_torch.cams.seeding import TCAMSeederCfg, tcam_seeder
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.losses.core import LossInputs, MasterLoss
from tcam_wsol_video_tpu_torch.ops.crf_inference import mean_field_refine
from tcam_wsol_video_tpu_torch.ops.interpolate import resize_bilinear


def make_train_step(master_loss: MasterLoss, args,
                    seeder_cfg: Optional[TCAMSeederCfg] = None):
    """Returns train_step(state, batch, switches, seed_weighted,
    generator=None, gumbel=None) -> metrics dict; state is updated in place
    (model parameters, BN statistics, optimizer, step).

    gumbel (B, 2, H*W) injects the seeder's fg/bg Gumbel noise; otherwise
    it is drawn from `generator`."""
    if args.task != constants.TCAM:
        raise NotImplementedError(f"only the TCAM step is ported "
                                  f"(got {args.task})")
    needs_seeds = bool(args.sl_tc)
    if needs_seeds and seeder_cfg is None:
        raise ValueError("sl_tc needs a seeder config")

    def train_step(state: TrainState, batch, switches: Sequence[float],
                   seed_weighted: bool,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None) -> dict:
        model, opt = state.model, state.optimizer
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
        out = model(batch["image"])
        logits = out["cl_logits"]
        inputs = LossInputs(epoch=state.epoch, fcams=out["fcams"],
                            raw_img=batch["raw_img"], seeds=seeds,
                            seq_iter=batch.get("seq_iter"),
                            frm_iter=batch.get("frm_iter"),
                            fg_size=batch.get("fg_size"),
                            msk_bbox=batch.get("msk_bbox"))
        total, holder = master_loss.compute(inputs, state.elb_t, switches)

        opt.zero_grad(set_to_none=False)
        total.backward()
        opt.step()
        state.step += 1

        with torch.no_grad():
            valid = batch.get("valid")
            if valid is None:
                valid = torch.ones(logits.shape[0], dtype=torch.bool,
                                   device=logits.device)
            pred = logits.argmax(-1)
            n_correct = ((pred == batch["label"]) & valid).sum()
        return {"loss": total.detach(), "n_correct": n_correct,
                "n": valid.sum(),
                **{k: v.detach() for k, v in holder.items()}}

    return train_step


def make_cam_eval_step(model, args):
    """Returns eval_step(images, raw_images=None) -> (cams (B, crop, crop)
    in [0, 1], cl_logits) for the TCAM task: the softmax foreground of the
    decoder output, nan-guarded, resized to the crop and clipped.  With
    args.crf_post_process and raw_images (B, crop, crop, 3) in [0, 255],
    the CAM is then refined by crf_pp_iters mean-field iterations."""
    if args.task not in (constants.F_CL, constants.TCAM):
        raise NotImplementedError(f"only the TCAM eval step is ported "
                                  f"(got {args.task})")
    crop = args.crop_size
    use_crf_pp = bool(args.crf_post_process)

    @torch.no_grad()
    def eval_step(images: torch.Tensor,
                  raw_images: Optional[torch.Tensor] = None):
        model.eval()
        out = model(images)
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
        return cam, out["cl_logits"]

    return eval_step
