"""Exact dense bilateral filter: the CUDA kernel's wrapper and its plain
PyTorch version.

    AS[b, i] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) v[b, j]

The kernel (csrc/bilateral.cu) replaces the TPU kernel
gaussian_filter_apply_pallas_batched (tcam_wsol_video_tpu/ops/pallas/
bilateral.py:159, body _kernel_batched_sym) and, through the B = 1 case,
gaussian_filter_apply_pallas (bilateral.py:210).  It is bound by the
operations: the weight is symmetric, so the function needs one ex2 and
about 2D + 2 + 4K fp32 flops per unordered pair, B P (P + 1) / 2 of them
(4.0e10 per recipe step); the kernel computes every ordered pair.  See
the source for the design.

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes the
plain version, which is the tests' oracle.  The kernel library is built
with nvcc into build/kernels/ at first use and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SOURCE = os.path.join(_REPO, "tcam_wsol_video_tpu_torch", "csrc",
                      "bilateral.cu")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
LIBRARY = os.path.join(BUILD_DIR, "libtcam_bilateral.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_D = 8
MAX_K = 8
_KERNEL_D = (3, 5, 8)   # feature widths the kernel is instantiated for
_KERNEL_K = (2, 8)      # value widths the kernel is instantiated for


class LaunchCounter:
    """Kernel launches (and plain-version calls) since the last reset."""

    def __init__(self):
        self.kernel = 0
        self.plain = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


counts = LaunchCounter()


def build(force: bool = False) -> dict:
    """Compile csrc/bilateral.cu with nvcc unless an up-to-date library is
    there.  Returns {'seconds', 'log'} (log: ptxas register/smem report)."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return {"seconds": 0.0, "log": "up to date"}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"seconds": time.perf_counter() - t0,
            "log": (res.stdout + res.stderr).strip()}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(LIBRARY)
    fn = lib.bilateral_exact_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(feats: torch.Tensor, vals: torch.Tensor) -> None:
    if feats.dim() != 3 or vals.dim() != 3:
        raise ValueError(f"feats (B,P,D) and vals (B,P,K) expected, got "
                         f"{tuple(feats.shape)} and {tuple(vals.shape)}")
    b, p, d = feats.shape
    if tuple(vals.shape[:2]) != (b, p) or p == 0:
        raise ValueError(f"shape mismatch {tuple(feats.shape)} vs "
                         f"{tuple(vals.shape)}")
    if not 1 <= d <= MAX_D or not 1 <= vals.shape[2] <= MAX_K:
        raise ValueError(f"need D <= {MAX_D} and K <= {MAX_K}, got "
                         f"D={d} K={vals.shape[2]}")
    if feats.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {feats.dtype}/{vals.dtype}")
    if feats.device != vals.device:
        raise ValueError(f"devices differ: {feats.device} vs {vals.device}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")


def _pad_last(x: torch.Tensor, widths) -> torch.Tensor:
    """Zero-pad the last axis up to the next width the kernel has."""
    n = x.shape[-1]
    target = next(w for w in widths if w >= n)
    if target == n:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, target - n)).contiguous()


def _launch(feats: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    b, p, _ = feats.shape
    k = vals.shape[2]
    f = _pad_last(feats, _KERNEL_D)
    v = _pad_last(vals, _KERNEL_K)
    out = torch.empty((b, p, v.shape[2]), dtype=torch.float32,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _library().bilateral_exact_forward(
            f.data_ptr(), v.data_ptr(), out.data_ptr(), b, p, f.shape[2],
            v.shape[2], stream)
    if err != 0:
        raise RuntimeError(f"bilateral_exact_forward launch failed: "
                           f"cudaError {err}")
    counts.kernel += 1
    return out if v.shape[2] == k else out[..., :k].contiguous()


def gaussian_filter_apply_plain(feats: torch.Tensor, vals: torch.Tensor,
                                row_block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version, tiled over query rows (the counterpart of the
    JAX crf.gaussian_filter_apply, batched).  The d2 matmul needs full
    fp32: on a card, keep torch.backends.cuda.matmul.allow_tf32 off.
    feats (B, P, D), vals (B, P, K) -> (B, P, K)."""
    counts.plain += 1
    feats = feats - feats.mean(dim=1, keepdim=True)
    sq = (feats * feats).sum(-1)                              # (B, P)
    out = []
    for r0 in range(0, feats.shape[1], row_block):
        fr = feats[:, r0:r0 + row_block]                      # (B, R, D)
        d2 = (sq[:, r0:r0 + row_block, None] + sq[:, None, :]
              - 2.0 * torch.bmm(fr, feats.transpose(1, 2)))
        wgt = torch.exp(-0.5 * d2.clamp_min(0.0))
        out.append(torch.bmm(wgt, vals))
    return torch.cat(out, dim=1)


def gaussian_filter_apply_batched(feats: torch.Tensor,
                                  vals: torch.Tensor) -> torch.Tensor:
    """feats (B, P, D<=8), vals (B, P, K<=8) fp32 -> (B, P, K) fp32.
    Features are centred per image here (distances are translation
    invariant; centring keeps the norm expansion well conditioned)."""
    _check(feats, vals)
    if feats.device.type == "cpu":
        return gaussian_filter_apply_plain(feats, vals)
    feats = feats - feats.mean(dim=1, keepdim=True)
    return _launch(feats, vals)


def gaussian_filter_apply(feats: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """Single image: feats (P, D), vals (P, K) -> (P, K); the B = 1 case of
    the batched kernel."""
    return gaussian_filter_apply_batched(feats[None], vals[None])[0]
