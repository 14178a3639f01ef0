"""Pretrained torchvision weights from a local file into the port's
encoders (port of models/import_torch.py).

A torchvision ResNet-50, VGG16 or Inception-v3 state_dict (or a
checkpoint holding one under "state_dict") maps onto the encoder's
parameters by name alone: the port's modules keep torch's layouts, so no
tensor is transposed.  As in JAX: ResNet-50's fc is dropped (the stride
surgery of layer3 / layer4 changes no shape); VGG16's first 13
`features.<k>` convolutions, in the order of k, become conv_0..conv_12
(conv6 keeps its initialisation); Inception-v3's stem and Mixed_5b-6e
load, Mixed_7*, AuxLogits and fc are dropped, and the SPG blocks keep
theirs.  BatchNorm's num_batches_tracked is not read.  Nothing is
downloaded.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

_BN = ("weight", "bias", "running_mean", "running_var")
_RESNET50_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6, "layer4": 3}
_A = ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
      "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")
_C = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
      "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
      "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
_INCEPTION_BLOCKS = {
    "Mixed_5b": _A, "Mixed_5c": _A, "Mixed_5d": _A,
    "Mixed_6a": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"),
    "Mixed_6b": _C, "Mixed_6c": _C, "Mixed_6d": _C, "Mixed_6e": _C}
_INCEPTION_STEMS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                    "Conv2d_3b_1x1", "Conv2d_4a_3x3")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch.save'd state_dict (or of its "state_dict"
    entry) on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _pairs_bn(src: str, dst: str) -> List[Tuple[str, str]]:
    return [(f"{src}.{n}", f"{dst}.{n}") for n in _BN]


def resnet50_names(sd: Dict) -> List[Tuple[str, str]]:
    """(torchvision name, encoder name) pairs of ResNet-50."""
    pairs = [("conv1.weight", "conv1.weight")] + _pairs_bn("bn1", "bn1")
    for lname, nb in _RESNET50_BLOCKS.items():
        for i in range(nb):
            src, dst = f"{lname}.{i}", f"{lname}_{i}"
            for j in (1, 2, 3):
                pairs.append((f"{src}.conv{j}.weight",
                              f"{dst}.conv{j}.weight"))
                pairs += _pairs_bn(f"{src}.bn{j}", f"{dst}.bn{j}")
            if f"{src}.downsample.0.weight" in sd:
                pairs.append((f"{src}.downsample.0.weight",
                              f"{dst}.downsample_conv.weight"))
                pairs += _pairs_bn(f"{src}.downsample.1",
                                   f"{dst}.downsample_bn")
    return pairs


def vgg16_names(sd: Dict) -> List[Tuple[str, str]]:
    convs = sorted({int(k.split(".")[1]) for k in sd
                    if k.startswith("features.") and k.endswith(".weight")})
    pairs = []
    for i, k in enumerate(convs[:13]):
        pairs += [(f"features.{k}.weight", f"conv_{i}.weight"),
                  (f"features.{k}.bias", f"conv_{i}.bias")]
    return pairs


def inception3_names(sd: Dict) -> List[Tuple[str, str]]:
    def conv_bn(name):
        return [(f"{name}.conv.weight", f"{name}.conv.weight")] + _pairs_bn(
            f"{name}.bn", f"{name}.bn")

    pairs = [p for stem in _INCEPTION_STEMS for p in conv_bn(stem)]
    for mixed, branches in _INCEPTION_BLOCKS.items():
        if (f"{mixed}.branch1x1.conv.weight" not in sd
                and f"{mixed}.branch3x3.conv.weight" not in sd):
            continue
        for br in branches:
            pairs += conv_bn(f"{mixed}.{br}")
    return pairs


NAME_MAPS = {"resnet50": resnet50_names, "vgg16": vgg16_names,
             "inceptionv3": inception3_names}


def encoder_state_from_torch(sd: Dict, encoder_name: str
                             ) -> Dict[str, torch.Tensor]:
    """torchvision-named tensors -> the encoder's state_dict entries."""
    if encoder_name not in NAME_MAPS:
        raise ValueError(f"no torchvision import for {encoder_name!r}; "
                         f"one of {sorted(NAME_MAPS)}")
    return {dst: torch.as_tensor(sd[src])
            for src, dst in NAME_MAPS[encoder_name](sd)}


def load_into_encoder(encoder: nn.Module,
                      state: Dict[str, torch.Tensor]) -> None:
    """Copies `state` into the encoder in place: every entry must name one
    of its parameters or buffers, at its shape (a strict load of what the
    file holds)."""
    own = encoder.state_dict()
    with torch.no_grad():
        for k, v in state.items():
            if k not in own:
                raise KeyError(f"the encoder has no {k}")
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: {tuple(own[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            own[k].copy_(v.to(own[k].dtype))


def load_pretrained_encoder(model: nn.Module, path: str,
                            encoder_name: str) -> nn.Module:
    """The torchvision weights of the file at `path` into model.encoder
    (on the model's device); returns the model."""
    load_into_encoder(model.encoder, encoder_state_from_torch(
        load_torch_state_dict(path), encoder_name))
    return model
