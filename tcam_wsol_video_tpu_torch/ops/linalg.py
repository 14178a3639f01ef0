"""Batched solves of the landmark filter's (M, M) ridge systems (port of
ops/linalg.py and of the solver choice of ops/crf.py).

Two solvers compute the same alpha, as in the JAX package:
- "cho" (the default, TCAM_LMK_SOLVER unset or "cho"): the library's
  batched Cholesky and two batched triangular solves, the counterpart of
  JAX's jax.scipy cho_factor/cho_solve; a CUDA graph captures it.
  `cholesky_ex` keeps the train step free of a host synchronisation on
  the error check: the factorization's `info` stays on the device, and a
  caller that wants it (chip_smoke.py) collects it inside `record_info()`
  and checks it is 0 afterwards.
  The factorizations whose `info` is not 0 are summed on the device as
  the counter crf.solve_failed (core/clock.TRACE.tally), read at the
  epoch's end.
- "lockstep" (TCAM_LMK_SOLVER=lockstep, and always between the two
  passes of the fused Nystrom kernels, as JAX's nystrom_filter_pallas
  solves there): `batched_block_cholesky_solve`, a blocked Cholesky in
  blocks of NB = 128 whose batch dimension goes through every sequential
  step together: per block, NB masked rank-1 factor steps and NB
  forward-substitution rows on (G, NB, NB) tensors, panel solves and
  trailing updates as batched products against the inverted diagonal
  blocks, then the block-triangular inverse by products and the solve as
  two products.  It is torch ops (in JAX it is XLA code, not a Pallas
  kernel); in eager mode its sequential steps are ~10^4 small launches
  at M = 1024.  fp32 throughout, for ridge-regularized kernel systems
  (K_mm + 1e-2 I).
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import torch

from tcam_wsol_video_tpu_torch.core.clock import TRACE

NB = 128  # block size of the lockstep solver (JAX: the TPU lane width)
SOLVERS = ("cho", "lockstep")

_recorders: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def record_info():
    """Collect the `info` tensor of every "cho" solve made inside the
    block (0 where the factorization succeeded, else the failing minor)."""
    rec: List[torch.Tensor] = []
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def landmark_solver() -> str:
    """The solver of the landmark filter, read at call time from
    TCAM_LMK_SOLVER as the JAX package reads it ("cho" when unset)."""
    solver = os.environ.get("TCAM_LMK_SOLVER", "cho")
    if solver not in SOLVERS:
        raise ValueError(f"TCAM_LMK_SOLVER={solver!r}; one of {SOLVERS}")
    return solver


def batched_cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for symmetric positive definite a (G, M, M) and
    b (G, M, K), fp32 -> (G, M, K): a = L L^T, then L y = b and L^T x = y.

    The two triangular solves are torch.cholesky_solve's, written out: on
    a card at G > 1 cholesky_solve calls MAGMA, whose batched solve aborts
    under a CUDA graph capture (its pointer arrays are set up by a device
    allocation), while solve_triangular takes cuBLAS's batched trsm."""
    chol, info = torch.linalg.cholesky_ex(a)
    TRACE.tally("crf.solve_failed", info != 0)
    for rec in _recorders:
        rec.append(info)
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def _chol_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of (..., n, n) PSD blocks by n rank-1 steps; the
    pivot is clamped at 1e-20 (JAX's _chol_unblocked, with each step's
    update restricted to the trailing submatrix its mask selects)."""
    a = a.clone()
    n = a.shape[-1]
    for r in range(n):
        d = torch.sqrt(a[..., r, r].clamp_min(1e-20))
        col = a[..., r:, r] / d[..., None]
        tail = col[..., 1:]
        a[..., r + 1:, r + 1:] -= tail[..., :, None] * tail[..., None, :]
        a[..., r:, r] = col
    return torch.tril(a)


def _tri_inv_unblocked(l_: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n) lower-triangular blocks by forward
    substitution, one row a step (JAX's _tri_inv_unblocked)."""
    n = l_.shape[-1]
    inv_d = 1.0 / torch.diagonal(l_, dim1=-2, dim2=-1).clamp_min(1e-20)
    x = torch.zeros_like(l_)
    eye = torch.eye(n, dtype=l_.dtype, device=l_.device)
    for r in range(n):
        acc = torch.matmul(l_[..., r:r + 1, :r], x[..., :r, :])[..., 0, :]
        x[..., r, :] = (eye[r] - acc) * inv_d[..., r, None]
    return x


def batched_block_cholesky_solve(a: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """The lockstep solve: a x = b for PSD a (G, M, M) with M % NB == 0
    and b (G, M, K), fp32 -> (G, M, K)."""
    g, m, _ = a.shape
    if m % NB:
        raise ValueError(f"M = {m} is not a multiple of {NB}")
    nb = m // NB
    if nb == 1:
        linv = _tri_inv_unblocked(_chol_unblocked(a))
        return torch.matmul(linv.transpose(1, 2), torch.matmul(linv, b))

    # (G, i, j, NB, NB) blocks; the trailing blocks are updated in place
    ab = a.reshape(g, nb, NB, nb, NB).permute(0, 1, 3, 2, 4).contiguous()
    lb = torch.zeros_like(ab)
    dinv = torch.zeros((g, nb, NB, NB), dtype=a.dtype, device=a.device)
    for j in range(nb):
        ljj = _chol_unblocked(ab[:, j, j])
        ljj_inv = _tri_inv_unblocked(ljj)
        lb[:, j, j] = ljj
        dinv[:, j] = ljj_inv
        if j + 1 < nb:
            # panel L_ij = A_ij L_jj^-T below the diagonal block, then the
            # trailing update A_ik -= L_ij L_kj^T
            panel = torch.matmul(ab[:, j + 1:, j], ljj_inv.transpose(1, 2)
                                 [:, None])
            lb[:, j + 1:, j] = panel
            ab[:, j + 1:, j + 1:] -= torch.matmul(
                panel[:, :, None], panel[:, None].transpose(-1, -2))

    # block-triangular inverse, one block row at a time:
    # Linv_ij = -Dinv_i sum_{j <= p < i} L_ip Linv_pj, Linv_ii = Dinv_i
    linv = torch.zeros_like(lb)
    for i in range(nb):
        linv[:, i, i] = dinv[:, i]
        if i:
            s = torch.einsum("gpnm,gpjmk->gjnk", lb[:, i, :i],
                             linv[:, :i, :i])
            linv[:, i, :i] = -torch.matmul(dinv[:, i, None], s)
    linv_full = linv.permute(0, 1, 3, 2, 4).reshape(g, m, m)
    return torch.matmul(linv_full.transpose(1, 2),
                        torch.matmul(linv_full, b))


def lockstep_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The lockstep solve at any M: a (G, M, M) padded to a multiple of NB
    with identity rows (their x solves I x = 0 and is sliced away), as
    the JAX landmark filter pads it."""
    g, m, _ = a.shape
    mp = -(-m // NB) * NB
    if mp == m:
        return batched_block_cholesky_solve(a, b)
    aa = torch.eye(mp, dtype=a.dtype, device=a.device).repeat(g, 1, 1)
    aa[:, :m, :m] = a
    bb = torch.nn.functional.pad(b, (0, 0, 0, mp - m))
    return batched_block_cholesky_solve(aa, bb)[:, :m]


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The landmark filter's solve with the solver of TCAM_LMK_SOLVER."""
    if landmark_solver() == "lockstep":
        return lockstep_solve(a, b)
    return batched_cholesky_solve(a, b)
