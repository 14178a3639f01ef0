"""The exact CRF filter's least time (harness/flops.filter_bound at
the cell's batch and crop: one filter a step) over the device time of its
kernels a step in the traced epoch, in %; None where no bilateral kernel
ran."""
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    t, crf = ctx.get("trace"), ctx.get("crf")
    if not t or not crf or not t.get("steps"):
        return None
    spent = kernel_seconds(t, "bilateral")
    if spent <= 0:
        return None
    return 100.0 * crf["bound_ms"] * 1e-3 * t["steps"] / spent
