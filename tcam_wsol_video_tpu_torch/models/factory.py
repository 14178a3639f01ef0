"""Model factory (port of models/factory.py): STDClassifier (STD_CL),
UnetFCAM (F_CL), UnetTCAM (TCAM, the same model) and DenseBoxNet (C_BOX,
with freeze_encoder) on the ResNet-50,
ResNet-101, VGG16 or InceptionV3 encoder and any pooling head, the last
two with the optional image-reconstruction head (im_rec).  The U-Net's
decoder has three blocks (256, 128, 64) and a center block on VGG, five
(256, 128, 64, 32, 16) otherwise.

The models hold fp32 parameters and take their compute dtype with each
forward (models/resnet.py), so one model serves the train step at
compute_dtype and the evaluator at eval_compute_dtype; DTYPES maps the
config's names to torch dtypes."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.models.classifier import (DenseBoxNet,
                                                         STDClassifier)
from tcam_wsol_video_tpu_torch.models.inception import inceptionv3_wsol
from tcam_wsol_video_tpu_torch.models.poolings import head_kwargs
from tcam_wsol_video_tpu_torch.models.resnet import (resnet50_wsol,
                                                     resnet101_wsol)
from tcam_wsol_video_tpu_torch.models.unet import UnetFCAM
from tcam_wsol_video_tpu_torch.models.vgg import vgg16_wsol

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_encoder(name: str) -> nn.Module:
    if name == constants.RESNET50:
        return resnet50_wsol()
    if name == "resnet101":
        return resnet101_wsol()
    if name == constants.VGG16:
        return vgg16_wsol()
    if name == constants.INCEPTIONV3:
        return inceptionv3_wsol()
    raise ValueError(f"unknown encoder {name!r}")


def decoder_channels_for(encoder_name: str):
    if encoder_name == constants.VGG16:
        return (256, 128, 64)
    return (256, 128, 64, 32, 16)


def create_model(task: str, encoder_name: str = constants.RESNET50,
                 num_classes: int = 10,
                 spatial_pooling: str = constants.WGAP,
                 freeze_cl: bool = False, im_rec: bool = False,
                 img_range: float = 1.0, head_kw: Optional[dict] = None,
                 freeze_encoder: bool = False, device="cuda") -> nn.Module:
    """head_kw: build_pooling_head's keyword arguments (support_background
    and the heads' hyperparameters; poolings.head_kwargs of a config)."""
    head_kw = head_kw or {}
    encoder = get_encoder(encoder_name)
    if task == constants.STD_CL:
        model = STDClassifier(encoder, spatial_pooling, num_classes,
                              **head_kw)
    elif task in (constants.F_CL, constants.TCAM):
        model = UnetFCAM(encoder, spatial_pooling, num_classes,
                         decoder_channels=decoder_channels_for(encoder_name),
                         seg_h_out_channels=2, freeze_cl=freeze_cl,
                         im_rec=im_rec, img_range=img_range,
                         center=encoder_name.startswith("vgg"), **head_kw)
    elif task == constants.C_BOX:
        model = DenseBoxNet(encoder, freeze_encoder=freeze_encoder)
    else:
        raise NotImplementedError(f"task {task} is not ported")
    return model.to(torch.device(device))


@TRACE.wrap("setup.model")
def create_model_from_args(args, override_arch_for_classifier: bool = False,
                           device="cuda") -> nn.Module:
    """The model of args.task; override_arch_for_classifier builds the
    stage-1 STD_CL classifier whatever the task, without freeze_cl."""
    t = constants.STD_CL if override_arch_for_classifier else args.task
    return create_model(t, args.encoder_name, args.num_classes,
                        args.spatial_pooling,
                        args.freeze_cl and not override_arch_for_classifier,
                        im_rec=args.im_rec, img_range=args.img_range,
                        head_kw=head_kwargs(args),
                        freeze_encoder=args.freeze_encoder, device=device)
