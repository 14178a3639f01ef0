"""The work a step needs, counted from the cell's shapes alone (so it
reads the same however the program computes the step), and the H100's
published peaks.

- Model FLOPs: torch.utils.flop_counter.FlopCounterMode over the
  reference model on the meta device at the cell's batch and crop: for
  TCAM the frozen encoder and head forward and the U-Net decoder's forward
  and backward; for STD_CL the whole forward and backward.  Cached in the
  checkout by configuration.
- The exact CRF's filter (chip_smoke.filter_bound, kept here): W is
  symmetric, so its least work is one exponential and 2D + 2 + 4K fp32
  flops for each of the B P (P + 1) / 2 unordered pixel pairs (D = 5
  features, K = 2 channels), reading features and values and writing W v
  once."""
from __future__ import annotations

import json
import os

import torch

# NVIDIA H100 SXM data sheet, dense, at 700 W
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# the MUFU's ex2: 16 a clock per SM against 128 fp32 FMA lanes
MUFU_RATE = FP32_FLOPS * 16 / 256
CRF_D, CRF_K = 5, 2


def model_flops(task: str, classes: int, batch: int, crop: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model as ref_model
    with torch.device("meta"):
        m = ref_model.build(task, classes)
        x = torch.zeros((batch, crop, crop, 3))
    with FlopCounterMode(display=False) as fc:
        out = m(x)
        y = out["fcams"] if task == "TCAM" else out["cl_logits"]
        y.float().sum().backward()
    return float(fc.get_total_flops())


def cached_model_flops(cache_dir: str, config: str, task: str,
                       classes: int, batch: int, crop: int) -> float:
    path = os.path.join(cache_dir, f"flops_{config}.json")
    key = [task, classes, batch, crop]
    if os.path.isfile(path):
        with open(path) as f:
            got = json.load(f)
        if got.get("key") == key:
            return float(got["flops"])
    flops = model_flops(task, classes, batch, crop)
    os.makedirs(cache_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"key": key, "flops": flops}, f)
    return flops


def filter_bound(b: int, p: int, d: int = CRF_D, k: int = CRF_K) -> dict:
    """Least work of one exact filter over B images of P pixels: the pairs,
    their operations and the least time by each bound, in ms."""
    pairs = b * p * (p + 1) // 2
    mufu_ms = pairs / MUFU_RATE * 1e3
    fp32_ms = pairs * (2 * d + 2 + 4 * k) / FP32_FLOPS * 1e3
    bytes_ms = 4 * b * p * (d + 2 * k) / HBM_BYTES_PER_S * 1e3
    return {"pairs": pairs, "ops": pairs * (2 * d + 3 + 4 * k),
            "mufu_ms": mufu_ms, "fp32_ms": fp32_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(mufu_ms, fp32_ms, bytes_ms)}
