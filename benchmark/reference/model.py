"""The models of the benchmark's configurations, in plain fp32 PyTorch.

- The WSOL ResNet-50 encoder: a torchvision-style bottleneck ResNet with
  layer3 and layer4 at stride 1 (output stride 8, 28 x 28 maps at 224 px),
  returning [x, stem, layer1, layer2, layer3, layer4].
- WGAP: global average pool, then a dense layer to the class logits.
- STDClassifier (stage 1): encoder + WGAP, BatchNorm on batch statistics.
- UnetTCAM (stage 2): encoder + WGAP frozen (no gradient, BatchNorm on its
  running statistics) + a U-Net decoder of five blocks (256, 128, 64, 32,
  16 channels; each a x2 nearest upsample, snapped back to the skip's size
  by an align-corners bilinear resize where they differ, a concatenation
  and two 3x3 conv + BatchNorm + ReLU) + a 3x3 segmentation head to 2
  channels at the input size.

The parameter and buffer names are the program's state-dict keys, so one
set of weights (made by harness/weights.py) loads into both.  Every
convolution and dense layer rounds its operands, its output and the
gradient at its output by `precision` (reference/precision.py: fp32 for
the reference, fp8 for the control, bf16 for the witness)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import activation, round_to

ENCODER_CHANNELS = (3, 64, 256, 512, 1024, 2048)
DECODER_CHANNELS = (256, 128, 64, 32, 16)
BN_EPS = 1e-5


def conv(m: nn.Conv2d, x: torch.Tensor, precision: str) -> torch.Tensor:
    bias = None if m.bias is None else round_to(m.bias, precision)
    return activation(F.conv2d(round_to(x, precision),
                               round_to(m.weight, precision), bias,
                               m.stride, m.padding), precision)


def bn(m: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Batch statistics (biased variance) in training, the running ones
    otherwise; the buffers are never updated here."""
    return F.batch_norm(x, m.running_mean.clone(), m.running_var.clone(),
                        m.weight, m.bias, training=train, momentum=0.0,
                        eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride)
            self.downsample_bn = nn.BatchNorm2d(planes * 4)

    def run(self, x, train: bool, p: str):
        y = F.relu(bn(self.bn1, conv(self.conv1, x, p), train))
        y = F.relu(bn(self.bn2, conv(self.conv2, y, p), train))
        y = bn(self.bn3, conv(self.conv3, y, p), train)
        if self.has_downsample:
            x = bn(self.downsample_bn, conv(self.downsample_conv, x, p),
                   train)
        return F.relu(y + x)


class ResNet50WSOL(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, stride=2)
        self.bn1 = nn.BatchNorm2d(64)
        self.stages: List[List[str]] = []
        cin = 64
        for (planes, stride, lname), n in zip(
                [(64, 1, "layer1"), (128, 2, "layer2"), (256, 1, "layer3"),
                 (512, 1, "layer4")], layers):
            names = []
            for i in range(n):
                self.add_module(f"{lname}_{i}", Bottleneck(
                    cin, planes, stride if i == 0 else 1, i == 0))
                cin = planes * 4
                names.append(f"{lname}_{i}")
            self.stages.append(names)

    def run(self, x_nchw, train: bool, p: str) -> List[torch.Tensor]:
        feats = [x_nchw]
        y = F.relu(bn(self.bn1, conv(self.conv1, x_nchw, p), train))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for names in self.stages:
            for name in names:
                y = getattr(self, name).run(y, train, p)
            feats.append(y)
        return feats


class WGAP(nn.Module):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.fc = nn.Linear(cin, classes)

    def run(self, x, p: str):
        return activation(F.linear(round_to(x.mean(dim=(2, 3)), p),
                                   round_to(self.fc.weight, p),
                                   round_to(self.fc.bias, p)), p)


class STDClassifier(nn.Module):
    def __init__(self, classes: int):
        super().__init__()
        self.encoder = ResNet50WSOL()
        self.classification_head = WGAP(ENCODER_CHANNELS[-1], classes)

    def forward(self, x_nhwc, precision: str = "fp32") -> dict:
        feats = self.encoder.run(x_nhwc.permute(0, 3, 1, 2), True, precision)
        return {"cl_logits": self.classification_head.run(feats[-1],
                                                          precision)}


# ----------------------------------------------------------- resampling
def linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """Row r: the source weights of output sample r (torch's bilinear)."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1 and (align_corners or n_in == 1):
        m[0, 0] = 1.0
        return m
    for r in range(n_out):
        if align_corners:
            src = r * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = min(max((r + 0.5) * n_in / n_out - 0.5, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        m[r, lo] += 1.0 - (src - lo)
        m[r, hi] += src - lo
    return m


def nearest_matrix(n_in: int, n_out: int) -> np.ndarray:
    """torch's nearest: source floor(r n_in / n_out)."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    for r in range(n_out):
        m[r, min(int(r * n_in / n_out), n_in - 1)] = 1.0
    return m


def resample(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray
             ) -> torch.Tensor:
    """mh @ x @ mw^T over the last two axes of an NCHW tensor."""
    a = torch.as_tensor(mh, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(mw, dtype=x.dtype, device=x.device)
    return torch.einsum("qw,...pw->...pq", b,
                        torch.einsum("ph,...hw->...pw", a, x))


class Conv2dReLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv(cin, cout, 3)
        self.bn = nn.BatchNorm2d(cout)

    def run(self, x, p: str):
        return F.relu(bn(self.bn, conv(self.conv, x, p), True))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + cskip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def run(self, x, skip, p: str):
        h, w = x.shape[-2:]
        if skip is not None and (2 * h, 2 * w) != tuple(skip.shape[-2:]):
            # nearest to 2x, then align-corners bilinear to the skip's size
            sh, sw = skip.shape[-2:]
            x = resample(x, linear_matrix(2 * h, sh, True)
                         @ nearest_matrix(h, 2 * h),
                         linear_matrix(2 * w, sw, True)
                         @ nearest_matrix(w, 2 * w))
        else:
            x = resample(x, nearest_matrix(h, 2 * h),
                         nearest_matrix(w, 2 * w))
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2.run(self.conv1.run(x, p), p)


class UnetDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        enc = list(ENCODER_CHANNELS[1:])[::-1]
        head, skips = enc[0], enc[1:]
        cin = head
        for i, ch in enumerate(DECODER_CHANNELS):
            cskip = skips[i] if i < len(skips) else 0
            self.add_module(f"block_{i}", DecoderBlock(cin, cskip, ch))
            cin = ch

    def run(self, features, p: str):
        feats = list(features[1:])[::-1]
        x, skips = feats[0], feats[1:]
        for i in range(len(DECODER_CHANNELS)):
            x = getattr(self, f"block_{i}").run(
                x, skips[i] if i < len(skips) else None, p)
        return x


class SegmentationHead(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv(cin, cout, 3, bias=True)


class UnetTCAM(nn.Module):
    """freeze_cl: the encoder and the head take no gradient and run their
    BatchNorm on the running statistics; the decoder's trains."""

    def __init__(self, classes: int):
        super().__init__()
        self.encoder = ResNet50WSOL()
        self.classification_head = WGAP(ENCODER_CHANNELS[-1], classes)
        self.decoder = UnetDecoder()
        self.segmentation_head = SegmentationHead(DECODER_CHANNELS[-1], 2)

    def forward(self, x_nhwc, precision: str = "fp32") -> dict:
        x = x_nhwc.permute(0, 3, 1, 2)
        with torch.no_grad():
            feats = self.encoder.run(x, False, precision)
            logits = self.classification_head.run(feats[-1], precision)
        fcams = conv(self.segmentation_head.conv,
                     self.decoder.run(feats, precision), precision)
        if tuple(fcams.shape[-2:]) != tuple(x.shape[-2:]):
            fcams = resample(
                fcams, linear_matrix(fcams.shape[-2], x.shape[-2], True),
                linear_matrix(fcams.shape[-1], x.shape[-1], True))
        return {"cl_logits": logits, "fcams": fcams.permute(0, 2, 3, 1)}


def build(task: str, classes: int) -> nn.Module:
    if task == "STD_CL":
        return STDClassifier(classes)
    if task == "TCAM":
        return UnetTCAM(classes)
    raise ValueError(f"no reference model for task {task!r}")


def head_rate_params(name: str) -> bool:
    """Parameters trained at the classifier's rate: the classification
    head and the encoder's layer4 (the recipe's lr_classifier_ratio)."""
    keys = name.split(".")
    return keys[0] == "classification_head" or (
        keys[0] == "encoder" and len(keys) > 1
        and keys[1].startswith("layer4"))
