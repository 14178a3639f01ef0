"""Model factory (port of models/factory.py): TCAM on ResNet-50."""
from __future__ import annotations

import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.models.resnet import resnet50_wsol
from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM


def create_model(task: str, encoder_name: str = constants.RESNET50,
                 num_classes: int = 10,
                 spatial_pooling: str = constants.WGAP,
                 freeze_cl: bool = False,
                 device="cuda") -> UnetTCAM:
    if task != constants.TCAM or encoder_name != constants.RESNET50:
        raise NotImplementedError(
            f"only TCAM on resnet50 is ported (got {task}/{encoder_name})")
    model = UnetTCAM(resnet50_wsol(), spatial_pooling, num_classes,
                     decoder_channels=(256, 128, 64, 32, 16),
                     seg_h_out_channels=2, freeze_cl=freeze_cl)
    return model.to(torch.device(device))


def create_model_from_args(args, device="cuda") -> UnetTCAM:
    return create_model(args.task, args.encoder_name, args.num_classes,
                        args.spatial_pooling, args.freeze_cl, device=device)
