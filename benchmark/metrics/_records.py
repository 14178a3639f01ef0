"""Helpers of the readers over the window's per-epoch train records."""
from __future__ import annotations

import numpy as np


def frames_per_s(ctx):
    return ctx["frames"] / ctx["window_s"]


def step_weighted(ctx, key: str):
    """The mean over the window's steps of a per-step record entry; None
    where the records lack it."""
    recs = [r for r in ctx.get("records", []) if key in r and r["steps"]]
    if not recs:
        return None
    return float(sum(r[key] * r["steps"] for r in recs)
                 / sum(r["steps"] for r in recs))


def median_step_ms(ctx):
    ms = [v for r in ctx.get("records", []) for v in r.get("step_ms", [])]
    return float(np.median(ms)) if ms else None


def mfu(ctx):
    """Model FLOPs (and the exact CRF filter's least operations) of the
    window's steps over its seconds, as a share of the H100's dense bf16
    peak, in %."""
    from benchmark.harness.flops import BF16_TENSOR_FLOPS
    if "model_flops_per_step" not in ctx:
        return None
    per_step = ctx["model_flops_per_step"] + (
        ctx["crf"]["ops"] if ctx.get("crf") else 0.0)
    return 100.0 * per_step * ctx["steps"] / ctx["window_s"] \
        / BF16_TENSOR_FLOPS


def idle(ctx):
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
