"""MasterLoss assembly for TCAM (port of losses/build.get_loss_tcam) for
the three losses of the stage-2 recipe."""
from __future__ import annotations

from tcam_wsol_video_tpu_torch.losses import tcam as tcam_losses
from tcam_wsol_video_tpu_torch.losses.core import MasterLoss

_NOT_PORTED = ("im_rec", "rgb_jcrf_tc", "size_bg_g_fg_tc", "sizefg_tmp_tc",
               "empty_out_bb_tc")


def get_loss_tcam(args) -> MasterLoss:
    on = [f for f in _NOT_PORTED if getattr(args, f)]
    if on:
        raise NotImplementedError(f"TCAM losses not ported yet: {on}")
    c = dict(seg_ignore_idx=args.seg_ignore_idx)
    ml = MasterLoss()
    if args.sl_tc:
        ml.add(tcam_losses.SelfLearningTcams(
            lambda_=args.sl_tc_lambda, start_ep=args.sl_tc_start_ep,
            end_ep=args.sl_tc_end_ep, **c))
    if args.crf_tc:
        ml.add(tcam_losses.ConRanFieldTcams(
            lambda_=args.crf_tc_lambda, sigma_rgb=args.crf_tc_sigma_rgb,
            sigma_xy=args.crf_tc_sigma_xy, scale_factor=args.crf_tc_scale,
            impl=args.crf_impl, start_ep=args.crf_tc_start_ep,
            end_ep=args.crf_tc_end_ep, **c))
    if args.max_sizepos_tc:
        ml.add(tcam_losses.MaxSizePositiveTcams(
            lambda_=args.max_sizepos_tc_lambda,
            start_ep=args.max_sizepos_tc_start_ep,
            end_ep=args.max_sizepos_tc_end_ep, **c))
    if not ml.losses:
        raise ValueError("TCAM training requires at least one loss flag")
    return ml
