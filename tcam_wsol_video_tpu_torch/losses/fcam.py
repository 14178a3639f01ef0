"""Cross-entropy with an ignore index (port of losses/fcam.py
cross_entropy_ignore), shared by the self-learning losses."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_ignore(fcams_logits: torch.Tensor, seeds: torch.Tensor,
                         ignore_idx: int) -> torch.Tensor:
    """Mean CE over non-ignored pixels.  fcams_logits (B, H, W, K); seeds
    (B, H, W) int in {0..K-1, ignore_idx}."""
    valid = seeds != ignore_idx
    tgt = torch.where(valid, seeds, 0).long()
    logp = torch.log_softmax(fcams_logits.float(), dim=-1)
    oh = F.one_hot(tgt, logp.shape[-1]).to(logp.dtype)
    nll = -(logp * oh).sum(-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)
