"""Model factory (port of models/factory.py): STDClassifier (STD_CL),
UnetFCAM (F_CL) and UnetTCAM (TCAM, the same model) on ResNet-50, the
last two with the optional image-reconstruction head (im_rec).

The models hold fp32 parameters and take their compute dtype with each
forward (models/resnet.py), so one model serves the train step at
compute_dtype and the evaluator at eval_compute_dtype; DTYPES maps the
config's names to torch dtypes."""
from __future__ import annotations

import torch
from torch import nn

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import resnet50_wsol
from tcam_wsol_video_tpu_torch.models.unet import UnetFCAM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def create_model(task: str, encoder_name: str = constants.RESNET50,
                 num_classes: int = 10,
                 spatial_pooling: str = constants.WGAP,
                 freeze_cl: bool = False, im_rec: bool = False,
                 img_range: float = 1.0, device="cuda") -> nn.Module:
    if encoder_name != constants.RESNET50:
        raise NotImplementedError(
            f"only the resnet50 encoder is ported (got {encoder_name})")
    if task == constants.STD_CL:
        model = STDClassifier(resnet50_wsol(), spatial_pooling, num_classes)
    elif task in (constants.F_CL, constants.TCAM):
        model = UnetFCAM(resnet50_wsol(), spatial_pooling, num_classes,
                         decoder_channels=(256, 128, 64, 32, 16),
                         seg_h_out_channels=2, freeze_cl=freeze_cl,
                         im_rec=im_rec, img_range=img_range)
    else:
        raise NotImplementedError(f"task {task} is not ported")
    return model.to(torch.device(device))


def create_model_from_args(args, override_arch_for_classifier: bool = False,
                           device="cuda") -> nn.Module:
    """The model of args.task; override_arch_for_classifier builds the
    stage-1 STD_CL classifier whatever the task, without freeze_cl."""
    t = constants.STD_CL if override_arch_for_classifier else args.task
    return create_model(t, args.encoder_name, args.num_classes,
                        args.spatial_pooling,
                        args.freeze_cl and not override_arch_for_classifier,
                        im_rec=args.im_rec, img_range=args.img_range,
                        device=device)
