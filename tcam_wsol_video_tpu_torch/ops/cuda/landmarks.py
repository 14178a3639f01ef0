"""Landmark (Nystrom) bilateral filter: the CUDA kernels' wrappers and
their plain PyTorch versions.

    K[b, p, m] = exp(-1/2 ||f[b, p] - fm[b, m]||^2)
    AS ~= K_nm (K_mm + ridge I)^-1 K_mn v

`build_knm` (csrc/landmarks.cu, build_knm_kernel) replaces the TPU kernel
build_knm_pallas (tcam_wsol_video_tpu/ops/pallas/landmarks.py:219): it
writes K_nm, or K_mm from (fm, fm), in fp32 or bf16; bound by the bytes
of the write.  `nystrom_filter` replaces nystrom_filter_pallas
(landmarks.py:91): pass 1 (`nystrom_rhs`) rhs = K_mn v, the lockstep
Cholesky solve (ops/linalg.py), pass 2 (`nystrom_out`) out = K_nm alpha;
K_nm is never written and each pass recomputes the weights, the cross term of
their exponents as a tensor-core product of fp16 operands split into hi
and lo parts (each feature must stay under 4.5e4 in magnitude); bound by
the operations (the ex2 on MUFU).  The kernels mask the ragged edges of P
and M themselves, so the landmark count needs no padding and there are
no pad landmarks.

A CUDA tensor goes to the kernels (or raises); only a CPU tensor takes
the plain versions, which are the tests' oracle.  Launch counters:
`knm_counts`, `rhs_counts` and `out_counts` (kernel launches, and calls of
build_knm_plain, nystrom_rhs_plain and nystrom_out_plain); each
build_knm call also counts crf.knm_builds and the MB it writes,
crf.knm_mb, on core/clock.TRACE.  Features are taken as given: the
callers centre them per image, which keeps the fp32 norm expansion of
the distance well conditioned (on a card, keep
torch.backends.cuda.matmul.allow_tf32 off for the plain versions).
"""
from __future__ import annotations

import functools

import torch

from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.ops import linalg
from tcam_wsol_video_tpu_torch.ops.cuda import build
from tcam_wsol_video_tpu_torch.ops.cuda.build import LaunchCounter

MAX_D = 8
MAX_K = 8
_KERNEL_D = (3, 5, 8)   # feature widths the kernels are instantiated for
_KERNEL_K = (2, 8)      # value widths of the Nystrom passes
OUT_DTYPES = (torch.float32, torch.bfloat16)
# pass 1 splits P so that about this many blocks are in flight
_RHS_TARGET_BLOCKS = 2048
_RHS_TILE = 128         # keys per shared-memory round (NYS_KEYS)
_RHS_LANDMARKS_PER_BLOCK = 256  # rows per block at K = 2 (nys_rows)

knm_counts = LaunchCounter()
rhs_counts = LaunchCounter()
out_counts = LaunchCounter()


@functools.lru_cache(maxsize=1)
def _entry_points():
    lib = build.load("landmarks")
    return {"knm": build.bind(lib, "landmarks_build_knm", 3, 5),
            "rhs": build.bind(lib, "landmarks_nystrom_rhs", 5, 6),
            "out": build.bind(lib, "landmarks_nystrom_out", 4, 5)}


def _check(feats: torch.Tensor, fm: torch.Tensor, vals=None,
           name: str = "vals") -> None:
    if feats.dim() != 3 or fm.dim() != 3:
        raise ValueError(f"feats (B,P,D) and fm (B,M,D) expected, got "
                         f"{tuple(feats.shape)} and {tuple(fm.shape)}")
    b, p, d = feats.shape
    if fm.shape[0] != b or fm.shape[2] != d or p == 0 or fm.shape[1] == 0:
        raise ValueError(f"shape mismatch {tuple(feats.shape)} vs "
                         f"{tuple(fm.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"need D <= {MAX_D}, got D={d}")
    tensors = [feats, fm] + ([vals] if vals is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"float32 expected, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != feats.device for t in tensors):
        raise ValueError(f"devices differ: {[t.device for t in tensors]}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    if vals is not None:
        rows = p if name == "vals" else fm.shape[1]
        if (vals.dim() != 3 or tuple(vals.shape[:2]) != (b, rows)
                or not 1 <= vals.shape[2] <= MAX_K):
            raise ValueError(f"{name} ({b},{rows},K<={MAX_K}) expected, got "
                             f"{tuple(vals.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# ------------------------------------------------------------- build_knm
def _knm_plain(feats: torch.Tensor, fm: torch.Tensor) -> torch.Tensor:
    """fp32 K (B, P, M), the counterpart of the JAX _kmat_batched, built
    in one (B, P, M) buffer."""
    sq = (feats * feats).sum(-1)
    sqm = (fm * fm).sum(-1)
    d2 = torch.bmm(feats, fm.transpose(1, 2))
    d2.mul_(-2.0).add_(sq[:, :, None]).add_(sqm[:, None, :])
    return d2.clamp_min_(0.0).mul_(-0.5).exp_()


def build_knm_plain(feats: torch.Tensor, fm: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of build_knm: fp32 distance and exp, then cast."""
    knm_counts.plain += 1
    return _knm_plain(feats, fm).to(out_dtype)


def build_knm(feats: torch.Tensor, fm: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """feats (B, P, D<=8) centred, fm (B, M, D) fp32 -> K (B, P, M) in
    out_dtype (float32 or bfloat16)."""
    _check(feats, fm)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}")
    b, p, _ = feats.shape
    m = fm.shape[1]
    TRACE.count("crf.knm_builds")
    TRACE.count("crf.knm_mb", b * p * m * out_dtype.itemsize / 1e6)
    if feats.device.type == "cpu":
        return build_knm_plain(feats, fm, out_dtype)
    f = build.pad_last(feats, _KERNEL_D)
    g = build.pad_last(fm, _KERNEL_D)
    out = torch.empty((b, p, m), dtype=out_dtype, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _entry_points()["knm"](
            f.data_ptr(), g.data_ptr(), out.data_ptr(), b, p, m, f.shape[2],
            int(out_dtype == torch.bfloat16), stream)
    _raise_on(err, "landmarks_build_knm")
    knm_counts.kernel += 1
    return out


# ------------------------------------------------------ Nystrom passes
def rhs_splits(b: int, p: int, m: int) -> int:
    """Slices of P that pass 1 sums separately (then adds in order)."""
    mblocks = -(-m // _RHS_LANDMARKS_PER_BLOCK)
    want = -(-_RHS_TARGET_BLOCKS // (b * mblocks))
    return max(1, min(want, -(-p // _RHS_TILE)))


def nystrom_rhs_plain(feats: torch.Tensor, fm: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """Plain version of pass 1: K_mn v (B, M, K) from a plain K_nm."""
    rhs_counts.plain += 1
    return torch.bmm(_knm_plain(feats, fm).transpose(1, 2), vals)


def nystrom_rhs(feats: torch.Tensor, fm: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Pass 1: rhs = K_mn v.  feats (B, P, D) centred, fm (B, M, D),
    vals (B, P, K<=8) fp32 -> (B, M, K) fp32."""
    _check(feats, fm, vals, "vals")
    if feats.device.type == "cpu":
        return nystrom_rhs_plain(feats, fm, vals)
    b, p, _ = feats.shape
    m, k = fm.shape[1], vals.shape[2]
    f = build.pad_last(feats, _KERNEL_D)
    g = build.pad_last(fm, _KERNEL_D)
    v = build.pad_last(vals, _KERNEL_K)
    kp = v.shape[2]
    nsplit = rhs_splits(b, p, m)
    partial = torch.empty((b, nsplit, m, kp), dtype=torch.float32,
                          device=feats.device)
    rhs = torch.empty((b, m, kp), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _entry_points()["rhs"](
            f.data_ptr(), g.data_ptr(), v.data_ptr(), partial.data_ptr(),
            rhs.data_ptr(), b, p, m, f.shape[2], kp, nsplit, stream)
    _raise_on(err, "landmarks_nystrom_rhs")
    rhs_counts.kernel += 1
    return rhs if kp == k else rhs[..., :k].contiguous()


def nystrom_out_plain(feats: torch.Tensor, fm: torch.Tensor,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of pass 2: K_nm alpha (B, P, K) from a plain K_nm."""
    out_counts.plain += 1
    return torch.bmm(_knm_plain(feats, fm), alpha)


def nystrom_out(feats: torch.Tensor, fm: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """Pass 2: out = K_nm alpha.  feats (B, P, D) centred, fm (B, M, D),
    alpha (B, M, K<=8) fp32 -> (B, P, K) fp32."""
    _check(feats, fm, alpha, "alpha")
    if feats.device.type == "cpu":
        return nystrom_out_plain(feats, fm, alpha)
    b, p, _ = feats.shape
    m, k = fm.shape[1], alpha.shape[2]
    f = build.pad_last(feats, _KERNEL_D)
    g = build.pad_last(fm, _KERNEL_D)
    a = build.pad_last(alpha, _KERNEL_K)
    out = torch.empty((b, p, a.shape[2]), dtype=torch.float32,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _entry_points()["out"](
            f.data_ptr(), g.data_ptr(), a.data_ptr(), out.data_ptr(), b, p,
            m, f.shape[2], a.shape[2], stream)
    _raise_on(err, "landmarks_nystrom_out")
    out_counts.kernel += 1
    return out if a.shape[2] == k else out[..., :k].contiguous()


# ------------------------------------------------------- fused filter
def add_ridge(kmm: torch.Tensor, ridge: float) -> torch.Tensor:
    """K_mm + ridge I, in place on the (B, M, M) block."""
    kmm.diagonal(dim1=1, dim2=2).add_(ridge)
    return kmm


def nystrom_filter_plain(feats: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor,
                         ridge: float = 1e-2) -> torch.Tensor:
    """Plain version of nystrom_filter (and of the whole landmark filter
    at fp32 K_nm): plain K_mm, rhs, the lockstep solve, out."""
    fm = feats[:, idx].contiguous()
    kmm = add_ridge(build_knm_plain(fm, fm), ridge)
    rhs = nystrom_rhs_plain(feats, fm, vals)
    alpha = linalg.lockstep_solve(kmm, rhs)
    return nystrom_out_plain(feats, fm, alpha)


def nystrom_filter(feats: torch.Tensor, vals: torch.Tensor,
                   idx: torch.Tensor, ridge: float = 1e-2) -> torch.Tensor:
    """Fused landmark filter: feats (B, P, D<=8) centred, vals
    (B, P, K<=8) fp32, idx (M,) landmark pixel indices -> (B, P, K).
    K_mm comes from build_knm, the two passes never write K_nm; between
    them the lockstep solve (ops/linalg.py), as JAX's
    nystrom_filter_pallas solves there."""
    if feats.device.type == "cpu":
        return nystrom_filter_plain(feats, vals, idx, ridge)
    fm = feats[:, idx].contiguous()
    kmm = add_ridge(build_knm(fm, fm), ridge)
    rhs = nystrom_rhs(feats, fm, vals)
    alpha = linalg.lockstep_solve(kmm, rhs)
    return nystrom_out(feats, fm, alpha)
