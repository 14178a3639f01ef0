"""MasterLoss assembly per task (port of losses/build.py): STD_CL is the
classification CE; for F_CL and TCAM each flag adds its elementary loss
with its lambda, epoch window and options (im_rec first, as in JAX); C_BOX
is losses/cbox.get_loss_cbox."""
from __future__ import annotations

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.losses import fcam as fcam_losses
from tcam_wsol_video_tpu_torch.losses import tcam as tcam_losses
from tcam_wsol_video_tpu_torch.losses.cbox import get_loss_cbox
from tcam_wsol_video_tpu_torch.losses.core import MasterLoss
from tcam_wsol_video_tpu_torch.losses.std import ClLoss


def get_loss(args) -> MasterLoss:
    if args.task == constants.STD_CL:
        return get_loss_std_cl(args)
    if args.task == constants.F_CL:
        return get_loss_fcam(args)
    if args.task == constants.TCAM:
        return get_loss_tcam(args)
    if args.task == constants.C_BOX:
        return get_loss_cbox(args)
    raise NotImplementedError(f"the losses of task {args.task} are not "
                              "ported")


def get_loss_std_cl(args) -> MasterLoss:
    return MasterLoss([ClLoss(lambda_=1.0,
                              seg_ignore_idx=args.seg_ignore_idx)])


def _im_rec(args, ml: MasterLoss, c: dict) -> None:
    if args.im_rec:
        ml.add(fcam_losses.ImgReconstruction(
            lambda_=args.im_rec_lambda, use_elb=args.im_rec_elb, **c))


def get_loss_fcam(args) -> MasterLoss:
    c = dict(seg_ignore_idx=args.seg_ignore_idx)
    ml = MasterLoss()
    _im_rec(args, ml, c)
    if args.sl_fc:
        ml.add(fcam_losses.SelfLearningFcams(
            lambda_=args.sl_fc_lambda, start_ep=args.sl_start_ep,
            end_ep=args.sl_end_ep, **c))
    if args.crf_fc:
        ml.add(fcam_losses.ConRanFieldFcams(
            lambda_=args.crf_lambda, sigma_rgb=args.crf_sigma_rgb,
            sigma_xy=args.crf_sigma_xy, scale_factor=args.crf_scale,
            impl=args.crf_impl, n_landmarks=args.crf_n_landmarks,
            rff_freqs=args.crf_rff_freqs,
            start_ep=args.crf_start_ep, end_ep=args.crf_end_ep, **c))
    if args.entropy_fc:
        ml.add(fcam_losses.EntropyFcams(lambda_=args.entropy_fc_lambda, **c))
    if args.max_sizepos_fc:
        ml.add(fcam_losses.MaxSizePositiveFcams(
            lambda_=args.max_sizepos_fc_lambda,
            start_ep=args.max_sizepos_fc_start_ep,
            end_ep=args.max_sizepos_fc_end_ep, **c))
    if not ml.losses:
        raise ValueError("F_CL training requires at least one loss flag")
    return ml


def get_loss_tcam(args) -> MasterLoss:
    c = dict(seg_ignore_idx=args.seg_ignore_idx)
    crf = dict(impl=args.crf_impl, n_landmarks=args.crf_n_landmarks,
               rff_freqs=args.crf_rff_freqs)
    ml = MasterLoss()
    _im_rec(args, ml, c)
    if args.sl_tc:
        ml.add(tcam_losses.SelfLearningTcams(
            lambda_=args.sl_tc_lambda, start_ep=args.sl_tc_start_ep,
            end_ep=args.sl_tc_end_ep, **c))
    if args.crf_tc:
        ml.add(tcam_losses.ConRanFieldTcams(
            lambda_=args.crf_tc_lambda, sigma_rgb=args.crf_tc_sigma_rgb,
            sigma_xy=args.crf_tc_sigma_xy, scale_factor=args.crf_tc_scale,
            start_ep=args.crf_tc_start_ep, end_ep=args.crf_tc_end_ep,
            **crf, **c))
    if args.rgb_jcrf_tc:
        if args.knn_tc <= 0:
            raise ValueError("the temporal joint CRF needs clip sampling "
                             "(knn_tc > 0)")
        ml.add(tcam_losses.RgbJointConRanFieldTcams(
            clip_len=2 * args.knn_tc + 1,
            lambda_=args.rgb_jcrf_tc_lambda,
            sigma_rgb=args.rgb_jcrf_tc_sigma_rgb,
            scale_factor=args.rgb_jcrf_tc_scale,
            start_ep=args.rgb_jcrf_tc_start_ep,
            end_ep=args.rgb_jcrf_tc_end_ep, **crf, **c))
    if args.max_sizepos_tc:
        ml.add(tcam_losses.MaxSizePositiveTcams(
            lambda_=args.max_sizepos_tc_lambda,
            start_ep=args.max_sizepos_tc_start_ep,
            end_ep=args.max_sizepos_tc_end_ep, **c))
    if args.size_bg_g_fg_tc:
        ml.add(tcam_losses.BgSizeGreatSizeFgTcams(
            lambda_=args.size_bg_g_fg_tc_lambda,
            start_ep=args.size_bg_g_fg_tc_start_ep,
            end_ep=args.size_bg_g_fg_tc_end_ep, **c))
    if args.sizefg_tmp_tc:
        ml.add(tcam_losses.FgSizeTcams(
            eps=args.sizefg_tmp_tc_eps, lambda_=args.sizefg_tmp_tc_lambda,
            start_ep=args.sizefg_tmp_tc_start_ep,
            end_ep=args.sizefg_tmp_tc_end_ep, **c))
    if args.empty_out_bb_tc:
        ml.add(tcam_losses.EmptyOutsideBboxTcams(
            lambda_=args.empty_out_bb_tc_lambda,
            start_ep=args.empty_out_bb_tc_start_ep,
            end_ep=args.empty_out_bb_tc_end_ep, **c))
    if not ml.losses:
        raise ValueError("TCAM training requires at least one loss flag")
    return ml
