"""A traced sub-window: torch.profiler over one call, reduced to what the
per-layer readers and the result's `device` and `breakdown` need.

The chrome trace the profiler exports is read back: device activity is
every event of category kernel, gpu_memcpy or gpu_memset; busy time is
the union of their intervals; an idle gap is a stretch between them, named
by the innermost host op running at its midpoint (or, where none runs, by
the last one that ended before it)."""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10
# kernel-name patterns by group, first match wins (chip_smoke.py's
# KERNEL_GROUPS: BN before the convolutions, since cuDNN's BN kernels say
# cudnn too; the convolutions before the GEMMs, whose implicit GEMMs say
# gemm)
KERNEL_GROUPS = (
    ("exact CRF", ("bilateral",)),
    ("landmark kernels", ("knm", "nystrom")),
    ("Cholesky solve", ("magma", "potrf", "potf2", "trsm", "trsv", "syrk",
                        "herk", "chol")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolutions", ("fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "conv", "cudnn")),
    ("GEMMs", ("gemm", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("transposes and copies", ("transpose", "copy", "permute", "nchw",
                               "nhwc", "memcpy")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "index", "scatter", "gather", "cat",
                                    "fill", "where", "sum", "norm",
                                    "memset")),
)


def traced(fn: Callable, path: str) -> Tuple[object, dict]:
    """Runs fn() under the profiler; returns (its result, the summary)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return out, summarize(events, wall)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], wall_s: float) -> dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS]
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    named = []
    for dur, a, b in gaps:
        mid = (a + b) / 2.0
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        if inside:
            name = min(inside, key=lambda e: e["dur"])["name"]
        else:
            before = [e for e in host if e["ts"] + e["dur"] < mid]
            name = ("after " + max(before, key=lambda e: e["ts"] + e["dur"]
                                   )["name"]) if before else "no host op"
        named.append([name, dur * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": wall_s,
            "kernels": dict(by_name),
            "breakdown": {"device_ops": [[n, s] for n, s in ops[:TOP]],
                          "idle_gaps": named}}


def groups(trace: dict) -> Dict[str, float]:
    """Device seconds by KERNEL_GROUPS group, the rest under "rest"."""
    out = {g: 0.0 for g, _ in KERNEL_GROUPS}
    out["rest"] = 0.0
    for name, s in trace["kernels"].items():
        low = name.lower()
        out[next((g for g, keys in KERNEL_GROUPS
                  if any(k in low for k in keys)), "rest")] += s
    return out


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name holds `pattern`."""
    return sum(s for n, s in trace["kernels"].items()
               if pattern in n.lower())
