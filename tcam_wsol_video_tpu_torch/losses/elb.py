"""Extended log-barrier for constraints f(x) <= 0 (port of losses/elb.py):
-log(-fx)/t where fx <= -1/t^2, else t*fx - log(1/t^2)/t + 1/t;
mean-reduced; and the per-epoch anneal of t."""
from __future__ import annotations

import numpy as np
import torch


def elb(fx: torch.Tensor, t: float) -> torch.Tensor:
    # a fill on fx's device, not a host copy (CUDA graphs capture it)
    t = torch.full((), float(t), dtype=torch.float32, device=fx.device)
    fx = fx.float()
    ct = -1.0 / (t * t)
    log_branch = -(1.0 / t) * torch.log((-fx).clamp_min(1e-30))
    lin_branch = t * fx - (1.0 / t) * torch.log(1.0 / (t * t)) + 1.0 / t
    return torch.where(fx <= ct, log_branch, lin_branch).mean()


def update_t(t: float, mulcoef: float, max_t: float) -> float:
    """The once-per-epoch anneal t <- min(t mulcoef, max_t), in float32
    as the JAX train state holds t."""
    return float(np.minimum(np.float32(t) * np.float32(mulcoef),
                            np.float32(max_t)))
