"""C_BOX losses (port of losses/cbox.py): ELB constraints on the predicted
box's area and on the frozen classifier's scores of its composites, the
CE of its soft masks against seeds, and the smooth-L1 pull towards the
pre-forward's box.

- AreaBox: ELB over (-area, area - H W) of the valid boxes (area over
  H W and bound 1 when area_normed);
- ClScoring: ELB over (clean - fg, bg - clean) of the label's logits of
  the valid boxes: the box must hold what makes the class score;
- SeedCbox: the CE of log-softmax over the stacked masks (m_bg, m_fg),
  taken as logits, against the seeds, over the seeded pixels of the
  valid boxes;
- BoxBounds: smooth-L1 between the box's extents and the pre-forward's.

The JAX package weights by validity where the reference indexes the
valid boxes; so does this port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tcam_wsol_video_tpu_torch.losses.core import (ElementaryLoss,
                                                   LossInputs, MasterLoss)
from tcam_wsol_video_tpu_torch.losses.elb import elb_masked_sum_count

Tensor = torch.Tensor


@dataclass
class CBoxInputs(LossInputs):
    """LossInputs with C_BOX's tensors: the box's extents x_hat, y_hat
    (B, 2), validity and area (B, 1), masks m_fg, m_bg (B, H, W), the
    classifier's logits of the fg, bg and clean images (B, K), and the
    pre-forward's extents pre_x_hat, pre_y_hat (B, 2)."""
    x_hat: Optional[Tensor] = None
    y_hat: Optional[Tensor] = None
    valid: Optional[Tensor] = None
    area: Optional[Tensor] = None
    m_fg: Optional[Tensor] = None
    m_bg: Optional[Tensor] = None
    logits_fg: Optional[Tensor] = None
    logits_bg: Optional[Tensor] = None
    logits_clean: Optional[Tensor] = None
    pre_x_hat: Optional[Tensor] = None
    pre_y_hat: Optional[Tensor] = None
    area_normed: bool = False


class _MaskedMean(ElementaryLoss):
    """A loss lambda num / max(den, 1) whose denominator counts the valid
    entries of the batch (compute_numden gives both, so that the ranks'
    shards sum to the global batch's)."""

    def sum_count(self, inputs: CBoxInputs, t: float):
        raise NotImplementedError

    def compute(self, inputs: CBoxInputs, t: float) -> Tensor:
        s, n = self.sum_count(inputs, t)
        return self.lambda_ * (s / n.clamp_min(1.0))

    def compute_numden(self, inputs: CBoxInputs, t: float):
        s, n = self.sum_count(inputs, t)
        return self.lambda_ * s.float(), n.float()


class AreaBox(_MaskedMean):
    def sum_count(self, inputs: CBoxInputs, t: float):
        area = inputs.area.reshape(-1)
        valid = inputs.valid.reshape(-1)
        h, w = inputs.m_fg.shape[-2:]
        if inputs.area_normed:
            area = area / float(h * w)
            upper = 1.0
        else:
            upper = float(h * w)
        fx = torch.cat([-area, area - upper])
        return elb_masked_sum_count(fx, t, torch.cat([valid, valid]))


class ClScoring(_MaskedMean):
    def sum_count(self, inputs: CBoxInputs, t: float):
        g = inputs.glabel.long()[:, None]
        fg = inputs.logits_fg.gather(1, g)[:, 0]
        bg = inputs.logits_bg.gather(1, g)[:, 0]
        cl = inputs.logits_clean.gather(1, g)[:, 0]
        valid = inputs.valid.reshape(-1)
        fx = torch.cat([cl - fg, bg - cl])
        return elb_masked_sum_count(fx, t, torch.cat([valid, valid]))


class SeedCbox(_MaskedMean):
    def sum_count(self, inputs: CBoxInputs, t: float):
        seg = torch.stack([inputs.m_bg, inputs.m_fg], -1).float()
        seeds = inputs.seeds
        seeded = seeds != self.seg_ignore_idx
        valid_px = seeded & (inputs.valid.reshape(-1, 1, 1) > 0)
        tgt = torch.where(seeded, seeds, 0).long()
        logp = torch.log_softmax(seg, -1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        nll = torch.where(valid_px, nll, 0.0)
        return nll.sum(), valid_px.sum()

    def compute(self, inputs: CBoxInputs, t: float) -> Tensor:
        s, n = self.sum_count(inputs, t)
        return self.lambda_ * s / n.clamp_min(1)


class BoxBounds(ElementaryLoss):
    def compute(self, inputs: CBoxInputs, t: float) -> Tensor:
        p = torch.cat([inputs.x_hat.reshape(-1), inputs.y_hat.reshape(-1)])
        pre = torch.cat([inputs.pre_x_hat.reshape(-1),
                         inputs.pre_y_hat.reshape(-1)])
        diff = pre - p
        ad = diff.abs()
        small = (ad < 1.0).float()
        loss = diff ** 2 * 0.5 * small + (ad - 0.5) * (1.0 - small)
        return self.lambda_ * loss.mean()


def get_loss_cbox(args) -> MasterLoss:
    """Each flag adds its loss with its lambda and epoch window, in JAX's
    order; cb_pp_box adds BoxBounds."""
    c = dict(seg_ignore_idx=args.seg_ignore_idx)
    ml = MasterLoss()
    if args.cb_area_box:
        ml.add(AreaBox(lambda_=args.cb_area_box_l,
                       start_ep=args.cb_area_box_start_epoch,
                       end_ep=args.cb_area_box_end_epoch, **c))
    if args.cb_cl_score:
        ml.add(ClScoring(lambda_=args.cb_cl_score_l,
                         start_ep=args.cb_cl_score_start_epoch,
                         end_ep=args.cb_cl_score_end_epoch, **c))
    if args.cb_seed:
        ml.add(SeedCbox(lambda_=args.cb_seed_l,
                        start_ep=args.cb_seed_start_epoch,
                        end_ep=args.cb_seed_end_epoch, **c))
    if args.cb_pp_box:
        ml.add(BoxBounds(lambda_=args.cb_pp_box_l,
                         start_ep=args.cb_pp_box_start_epoch,
                         end_ep=args.cb_pp_box_end_epoch, **c))
    if not ml.losses:
        raise ValueError("C_BOX training requires at least one loss flag")
    return ml
