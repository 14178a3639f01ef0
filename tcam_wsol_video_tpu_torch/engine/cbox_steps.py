"""Train and eval steps of the C_BOX task (port of engine/cbox_steps.py).

One train step:
1. pre-forward, the model in eval mode without gradient: its box, clamped
   into the image, is the BoxBounds target, unless it is invalid or its
   area share is under the minimum size (per class from the val split's
   GT boxes under size_data, else cb_pp_box_min_size): then a centred box
   of area share s ~ N(cb_init_box_size, cb_init_box_var) (a std, as the
   reference uses it), clamped to [minimum, 0.99], takes its place;
2. seeds from the batch's CAMs (cbox_seeder) and the Gaussian blur of the
   images;
3. forward in training mode: the box's soft masks (ops/box_stats);
4. the frozen classifier scores the composites: the box kept and its
   outside blurred (fg), and with cb_cl_score also the box blurred (bg)
   and the clean image.  The classifier is frozen by requires_grad_(False)
   and eval mode, not by no_grad: the gradient reaches the box through it;
5. the C_BOX losses (losses/cbox.py), one SGD update.

Both models run at args.compute_dtype in the train step, as JAX builds
them.  The eval step runs the box model at args.eval_compute_dtype and the
classifier at args.compute_dtype (JAX's evaluator rebuilds the box model
at the eval dtype and keeps the CLI's classifier).

Noise: the fallback boxes' normal draws (B,), the seeder's Gumbel noise
(B, 2, H W) and bg fractions (B,) come from `generator`, or from `noise`
({"normal", "gumbel", "z"}) when it is given.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.seeding import CBoxSeederCfg, cbox_seeder
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.data.transforms import normalize_u8_scaled
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import expand_compact_batch
from tcam_wsol_video_tpu_torch.losses.cbox import CBoxInputs
from tcam_wsol_video_tpu_torch.losses.core import MasterLoss
from tcam_wsol_video_tpu_torch.models.factory import DTYPES
from tcam_wsol_video_tpu_torch.ops.box_stats import (box_stats,
                                                     compose_bg_image,
                                                     compose_fg_image,
                                                     gaussian_blur)
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh
from tcam_wsol_video_tpu_torch.parallel.mesh import global_draw

Tensor = torch.Tensor


def init_boxes(normal: Tensor, h: int, w: int, minsz: Tensor,
               size_mean: float, size_var: float) -> Tuple[Tensor, Tensor]:
    """Centred fallback boxes (x_hat, y_hat), each (n, 2), of area share
    s = size_mean + size_var normal clamped to [minsz, 0.99]; x binds the
    height axis."""
    s = torch.maximum(size_mean + size_var * normal, minsz).clamp_max(0.99)
    half = torch.sqrt(s) / 2.0
    x_hat = torch.stack([(h / 2.0 - h * half).clamp_min(0.0),
                         (h / 2.0 + h * half).clamp_max(h - 1.0)], 1)
    y_hat = torch.stack([(w / 2.0 - w * half).clamp_min(0.0),
                         (w / 2.0 + w * half).clamp_max(w - 1.0)], 1)
    return x_hat, y_hat


def make_cbox_train_step(master_loss: MasterLoss, args,
                         seeder_cfg: Optional[CBoxSeederCfg],
                         classifier,
                         size_priors_min_s: Optional[np.ndarray] = None,
                         mesh: Optional[pmesh.Mesh] = None):
    """Returns train_step(state, batch, switches, seed_weighted=False,
    generator=None, noise=None, student=None, dropout_generator=None) ->
    metrics dict; state is updated in place.  The signature is
    engine/steps.make_train_step's, so that the trainer has one call site:
    seed_weighted and student (TCAM's) are ignored.
    batch: image (B, H, W, 3) normalized (or a compact batch),
    label (B,), std_cam (B, H, W) when cb_seed, optional valid (B,).
    size_priors_min_s (num_classes,): the per-class minimum area share,
    read under cb_pp_box_min_size_type == size_data.  mesh: as
    engine/steps.make_train_step's."""
    if args.cb_seed and seeder_cfg is None:
        raise ValueError("cb_seed needs a seeder config")
    h = w = args.crop_size
    scale = args.cb_scale_domain
    dtype = DTYPES[args.compute_dtype]
    use_prior = (args.cb_pp_box_min_size_type == constants.SIZE_DATA
                 and size_priors_min_s is not None)
    priors = {}   # the priors per device

    def min_sizes(labels: Tensor) -> Tensor:
        if not use_prior:
            return torch.full(labels.shape, args.cb_pp_box_min_size,
                              dtype=torch.float32, device=labels.device)
        dev = labels.device
        if dev not in priors:
            priors[dev] = torch.as_tensor(size_priors_min_s,
                                          dtype=torch.float32).to(dev)
        return priors[dev][labels.long()]

    def train_step(state: TrainState, batch, switches: Sequence[float],
                   seed_weighted: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[dict] = None, student=None,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> dict:
        model, opt = state.model, state.optimizer
        noise = noise or {}
        batch = expand_compact_batch(batch)
        images, labels = batch["image"], batch["label"]
        n, dev = images.shape[0], images.device
        minsz = min_sizes(labels)

        with torch.no_grad():
            model.eval()
            px, py, pvalid, parea, _, _ = box_stats(
                model(images, dtype)["box"], h, w, scale, eval_mode=True)
            normal = noise.get("normal")
            if normal is None:
                normal = global_draw(torch.randn, (n,), generator=generator,
                                     dtype=torch.float32, device=dev)
            rx, ry = init_boxes(normal, h, w, minsz, args.cb_init_box_size,
                                args.cb_init_box_var)
            bad = ((pvalid == 0) | (parea / float(h * w) < minsz))[:, None]
            pre_x = torch.where(bad, rx, px)
            pre_y = torch.where(bad, ry, py)
            seeds = None
            if args.cb_seed:
                seeds = cbox_seeder(batch["std_cam"], seeder_cfg,
                                    generator=generator,
                                    gumbel=noise.get("gumbel"),
                                    z=noise.get("z"))
            blurred = gaussian_blur(images, args.cb_cl_score_blur_ksize,
                                    args.cb_cl_score_blur_sigma)

        model.train()
        classifier.eval()
        box = model(images, dtype, dropout_generator)["box"]
        x, y, valid, area, m_fg, m_bg = box_stats(box, h, w, scale)
        logits_fg = classifier(compose_fg_image(images, blurred, m_fg, m_bg),
                               dtype)["cl_logits"]
        logits_bg = logits_clean = None
        if args.cb_cl_score:
            logits_bg = classifier(
                compose_bg_image(images, blurred, m_fg, m_bg),
                dtype)["cl_logits"]
            logits_clean = classifier(images, dtype)["cl_logits"]
        inputs = CBoxInputs(
            epoch=state.epoch, glabel=labels, raw_img=batch.get("raw_img"),
            x_in=images, seeds=seeds, x_hat=x, y_hat=y,
            valid=valid[:, None], area=area[:, None], m_fg=m_fg, m_bg=m_bg,
            logits_fg=logits_fg, logits_bg=logits_bg,
            logits_clean=logits_clean, pre_x_hat=pre_x, pre_y_hat=pre_y)
        if mesh is not None and mesh.dp_group is not None:
            total, holder = master_loss.compute_global(
                inputs, state.elb_t, switches, mesh.dp_group)
        else:
            total, holder = master_loss.compute(inputs, state.elb_t,
                                                switches)

        opt.zero_grad(set_to_none=False)
        total.backward()
        pmesh.sync_grads(model, mesh)
        opt.step()
        state.step += 1

        with torch.no_grad():
            bvalid = batch.get("valid")
            if bvalid is None:
                bvalid = torch.ones(n, dtype=torch.bool, device=dev)
            pred = logits_fg.argmax(-1)
            n_correct = ((pred == labels) & bvalid).sum()
        return pmesh.reduce_metrics(
            {"loss": total.detach(), "n_correct": n_correct,
             "n": bvalid.sum(), "valid_boxes": (valid * bvalid).sum(),
             **{k: v.detach() for k, v in holder.items()}}, mesh)

    return pmesh.within(mesh, train_step)


def make_cbox_eval_step(model, classifier, args):
    """Returns eval_step(images) -> (boxes (B, 4) as (x0, y0, x1, y1) in
    the image's width and height, validity (B,), the classifier's logits
    of the fg composite).  uint8 images (h2d_transfer=uint8) are
    normalized first.  The box is clamped into the image."""
    h = w = args.crop_size
    scale = args.cb_scale_domain
    dtype = DTYPES[args.eval_compute_dtype]
    cls_dtype = DTYPES[args.compute_dtype]

    @torch.no_grad()
    def eval_step(images: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        model.eval()
        classifier.eval()
        if images.dtype == torch.uint8:
            images = normalize_u8_scaled(images.to(torch.float32))
        x, y, valid, _, m_fg, m_bg = box_stats(
            model(images, dtype)["box"], h, w, scale, eval_mode=True)
        blurred = gaussian_blur(images, args.cb_cl_score_blur_ksize,
                                args.cb_cl_score_blur_sigma)
        logits = classifier(compose_fg_image(images, blurred, m_fg, m_bg),
                            cls_dtype)["cl_logits"]
        # x binds the height axis: the public box is (y0, x0, y1, x1)
        boxes = torch.stack([y[:, 0], x[:, 0], y[:, 1], x[:, 1]], 1)
        return boxes.float(), valid, logits

    return eval_step
