"""The device ms a step of the whole landmark filter in the traced epoch:
the kernels of harness/trace.py's groups "landmark kernels" (kernel 4,
build_knm, writing K_nm and K_mm) and "Cholesky solve" (cuSOLVER's
batched potrf, cuBLAS's batched trsm), and the two fp32 products K_mn s
and K_nm alpha (cuBLAS's fp32 GEMMs, sm80_xmma_gemm_f32f32_f32f32_f32_*
on the H100; the rest of the step's products are bf16); None where no
landmark kernel ran."""
from benchmark.harness.trace import groups, kernel_seconds

PRODUCTS = "gemm_f32f32_f32f32_f32"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    g = groups(t)
    if g["landmark kernels"] <= 0:
        return None
    spent = (g["landmark kernels"] + g["Cholesky solve"]
             + kernel_seconds(t, PRODUCTS))
    return 1e3 * spent / t["steps"]
