"""Kernel 4's least time a step (harness/landmark_bound.knm_bound at the
cell's batch, crop and landmarks: K_nm and K_mm written, the features
read) over the device time a step of its build_knm kernels in the traced
epoch, in %; None where no build_knm kernel ran."""
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    t, knm = ctx.get("trace"), ctx.get("knm")
    if not t or not knm or not t.get("steps"):
        return None
    spent = kernel_seconds(t, "build_knm")
    if spent <= 0:
        return None
    return 100.0 * knm["bound_ms"] * 1e-3 * t["steps"] / spent
