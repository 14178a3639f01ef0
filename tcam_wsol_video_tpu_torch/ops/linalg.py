"""Batched Cholesky solve of the landmark filter's (M, M) ridge systems
(counterpart of the JAX package's jax.scipy cho_factor/cho_solve, the
landmark path's default "cho" solver, and of its lockstep
ops/linalg.batched_block_cholesky_solve: both compute the same alpha).

In JAX this solve is XLA code, not a Pallas kernel; here it is the
library's batched Cholesky.  `cholesky_ex` keeps the train step free of a
host synchronisation on the error check: the factorization's `info`
stays on the device, and a caller that wants it (chip_smoke.py) collects
it inside `record_info()` and checks it is 0 afterwards.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

_recorders: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def record_info():
    """Collect the `info` tensor of every solve made inside the block
    (0 where the factorization succeeded, else the failing minor)."""
    rec: List[torch.Tensor] = []
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def batched_cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for symmetric positive definite a (G, M, M) and
    b (G, M, K), fp32 -> (G, M, K)."""
    chol, info = torch.linalg.cholesky_ex(a)
    for rec in _recorders:
        rec.append(info)
    return torch.cholesky_solve(b, chol)
