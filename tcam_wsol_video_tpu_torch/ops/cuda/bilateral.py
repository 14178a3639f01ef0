"""Exact dense bilateral filter: the CUDA kernel's wrapper, its schedule and
its plain PyTorch version.

    AS[b, i] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) v[b, j]

The kernel (csrc/bilateral.cu) replaces the TPU kernel
gaussian_filter_apply_pallas_batched (tcam_wsol_video_tpu/ops/pallas/
bilateral.py:159, body _kernel_batched_sym) and, through the B = 1 case,
gaussian_filter_apply_pallas (bilateral.py:210).  It is bound by the
operations: the weight is symmetric, so the function needs one ex2 and
about 2D + 2 + 4K fp32 flops per unordered pair, B P (P + 1) / 2 of them
(4.0e10 per recipe step).  The kernel computes each unordered tile pair
once on a circulant schedule (`schedule` below) and writes column sums to
a scratch that a second kernel adds in a fixed order: no atomics, bit-equal
results from call to call.  See the source for the design.

One filter call counts one launch in `counts.kernel`; it issues two CUDA
launches (pair kernel, reduction) per batch chunk.  The batch is chunked
so that the scratch stays under SCRATCH_CAP bytes (one image over the cap
still runs, alone).

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes the
plain version, which is the tests' oracle.  The kernel library is built
with nvcc into build/kernels/ at first use and bound with ctypes
(ops/cuda/build.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import torch

from tcam_wsol_video_tpu_torch.ops.cuda import build
from tcam_wsol_video_tpu_torch.ops.cuda.build import LaunchCounter

MAX_D = 8
MAX_K = 8
_KERNEL_D = (3, 5, 8)   # feature widths the kernel is instantiated for
_KERNEL_K = (2, 8)      # value widths the kernel is instantiated for
TILE = 256              # pixels per tile; csrc/bilateral.cu's TILE
BLOCKS_PER_SM = 8       # split strips until the grid has this many blocks per SM
SCRATCH_CAP = 2 << 30   # bytes of scratch per launch before B is chunked

counts = LaunchCounter()


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The pair kernel's decomposition of B images of P pixels into tiles.

    Row tile i owns offsets o (key tile j = (i + o) mod n): o = 0, the
    diagonal tile, in the row direction only; o = 1 .. (n - 1) // 2; and
    o = n // 2 when n is even and i < n // 2.  Its offsets are cut into
    `nsplit` contiguous pieces, one block each: grid (n nsplit, B).  Scratch
    slot s < nsplit holds piece s's row sums, slot nsplit + o - 1 the
    column sums of the pairs at offset o."""
    batch: int
    pixels: int
    k: int
    tile: int
    n_tiles: int
    nsplit: int

    def row_offsets(self, i: int) -> int:
        n = self.n_tiles
        return 1 + (n - 1) // 2 + (1 if n % 2 == 0 and i < n // 2 else 0)

    def block_offsets(self, i: int, s: int) -> range:
        """Offsets of block (row tile i, piece s)."""
        length = -(-(1 + self.n_tiles // 2) // self.nsplit)
        return range(s * length, min(self.row_offsets(i), (s + 1) * length))

    def column_slots(self, j: int) -> int:
        """Column-sum slots written for column tile j (offsets 1 ..)."""
        n = self.n_tiles
        return (n - 1) // 2 + (1 if n % 2 == 0 and j >= n // 2 else 0)

    @property
    def scratch_shape(self) -> Tuple[int, int, int, int]:
        return (self.batch, self.nsplit + self.n_tiles // 2, self.pixels,
                self.k)

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape)


def schedule(batch: int, pixels: int, k: int, n_sm: int,
             tile: int = TILE) -> Schedule:
    """Tiles, strip split and scratch of one launch.  Strips are split
    (nsplit > 1) only when batch * n_tiles blocks would not give every SM
    BLOCKS_PER_SM blocks, e.g. at B = 1."""
    n = -(-pixels // tile)
    want = BLOCKS_PER_SM * n_sm
    nsplit = min(1 + n // 2, max(1, -(-want // (batch * n))))
    return Schedule(batch, pixels, k, tile, n, nsplit)


def plan(batch: int, pixels: int, k: int, n_sm: int,
         cap: int = SCRATCH_CAP, tile: int = TILE
         ) -> List[Tuple[int, Schedule]]:
    """Batch chunks [(start, schedule)] whose scratch each fits in `cap`
    (a chunk of one image may not)."""
    per_image = schedule(1, pixels, k, n_sm, tile).scratch_bytes
    step = max(1, cap // per_image)
    return [(b0, schedule(min(step, batch - b0), pixels, k, n_sm, tile))
            for b0 in range(0, batch, step)]


@functools.lru_cache(maxsize=1)
def _forward():
    lib = build.load("bilateral")
    tile = lib.bilateral_exact_tile()
    if tile != TILE:
        raise RuntimeError(f"csrc/bilateral.cu tiles by {tile}, the wrapper "
                           f"by {TILE}")
    return build.bind(lib, "bilateral_exact_forward", 4, 5)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _launch(feats: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    b, p, _ = feats.shape
    k = vals.shape[2]
    f = build.pad_last(feats, _KERNEL_D)
    v = build.pad_last(vals, _KERNEL_K)
    kp = v.shape[2]
    out = torch.empty((b, p, kp), dtype=torch.float32, device=feats.device)
    forward = _forward()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        for b0, sch in plan(b, p, kp, sm_count(feats.device.index or 0),
                                cap=SCRATCH_CAP):
            b1 = b0 + sch.batch
            scratch = torch.empty(sch.scratch_shape, dtype=torch.float32,
                                  device=feats.device)
            err = forward(f[b0:b1].data_ptr(), v[b0:b1].data_ptr(),
                          scratch.data_ptr(), out[b0:b1].data_ptr(),
                          sch.batch, p, f.shape[2], kp, sch.nsplit, stream)
            if err != 0:
                raise RuntimeError(f"bilateral_exact_forward launch failed: "
                                   f"cudaError {err}")
    counts.kernel += 1
    return out if kp == k else out[..., :k].contiguous()


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
