"""Extended log-barrier for constraints f(x) <= 0 (port of losses/elb.py):
-log(-fx)/t where fx <= -1/t^2, else t*fx - log(1/t^2)/t + 1/t;
mean-reduced (elb), or summed over the masked entries with their count
(elb_masked_sum_count: C_BOX's valid boxes, whose losses divide the one
by the other); and the per-epoch anneal of t."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _elb_terms(fx: torch.Tensor, t) -> torch.Tensor:
    # t a float, or a 0-d tensor read on the device (the chunked route's,
    # which a kept CUDA graph reads each epoch); a float is filled on fx's
    # device, not copied from the host (CUDA graphs capture the fill)
    t = (t.to(device=fx.device, dtype=torch.float32)
         if isinstance(t, torch.Tensor)
         else torch.full((), float(t), dtype=torch.float32, device=fx.device))
    fx = fx.float()
    ct = -1.0 / (t * t)
    log_branch = -(1.0 / t) * torch.log((-fx).clamp_min(1e-30))
    lin_branch = t * fx - (1.0 / t) * torch.log(1.0 / (t * t)) + 1.0 / t
    return torch.where(fx <= ct, log_branch, lin_branch)


def elb(fx: torch.Tensor, t: float) -> torch.Tensor:
    return _elb_terms(fx, t).mean()


def elb_masked_sum_count(fx: torch.Tensor, t: float, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ELB's sum over the entries where mask is non-zero, their
    count)."""
    m = mask.float()
    return (_elb_terms(fx, t) * m).sum(), m.sum()


def update_t(t: float, mulcoef: float, max_t: float) -> float:
    """The once-per-epoch anneal t <- min(t mulcoef, max_t), in float32
    as the JAX train state holds t."""
    return float(np.minimum(np.float32(t) * np.float32(mulcoef),
                            np.float32(max_t)))
