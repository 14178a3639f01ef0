"""JAX flax variables -> the port's state_dict.

The inverse of the JAX package's models/import_torch.py: conv kernels
HWIO -> OIHW, Dense (in, out) -> (out, in), BatchNorm scale/bias ->
weight/bias and batch_stats mean/var -> running_mean/running_var.  The
port's modules carry the flax names, so a parameter's path in the flax
tree is its name in the state_dict.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """{'params': ..., 'batch_stats': ...} (numpy leaves) -> state_dict."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(variables["params"]):
        name = ".".join(path[:-1] + (_PARAM_NAMES[path[-1]],))
        if path[-1] == "kernel":
            leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
        out[name] = np.ascontiguousarray(leaf, dtype=np.float32)
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        name = ".".join(path[:-1] + (_STAT_NAMES[path[-1]],))
        out[name] = np.ascontiguousarray(leaf, dtype=np.float32)
    return out


def load_flax_variables(model: nn.Module, variables) -> None:
    """Copy flax variables into `model` in place; every parameter and BN
    statistic must be matched (num_batches_tracked has no flax
    counterpart and is left alone)."""
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"transplant mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"{k}: {tuple(own[k].shape)} vs {v.shape}")
            own[k].copy_(torch.tensor(v))
