"""Rolling training checkpoints and best-model snapshots, as torch files
(port of core/checkpoint.py).

- `{step}_checkpoint.pt`: model and optimizer state, ELB t, step and
  epoch; `find_last_checkpoint` takes the highest step,
  `keep_last_n_checkpoints` prunes the others.
- `{step}_best_model.pt` in a snapshot folder (best_localization,
  best_classification): the model's state split by component (encoder,
  classification_head, decoder, segmentation_head) with step, epoch and
  ELB t; only the newest is kept.  Components load strictly, one by one.
Files are written atomically.  The JAX package's msgpack checkpoints are
not read here: weights cross over through models/transplant.py.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

_CKPT_RE = re.compile(r"^(\d+)_checkpoint\.pt$")
_BEST_RE = re.compile(r"^(\d+)_best_model\.pt$")


def _atomic_save(obj, path: str) -> None:
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _steps(folder: str, pattern) -> List[Tuple[int, str]]:
    if not os.path.isdir(folder):
        return []
    found = []
    for f in os.listdir(folder):
        m = pattern.match(f)
        if m:
            found.append((int(m.group(1)), f))
    return sorted(found)


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def save_checkpoint(folder: str, state, model_sd: Optional[dict] = None,
                    optimizer_sd: Optional[dict] = None) -> str:
    """state: engine.state.TrainState; model_sd / optimizer_sd: the states
    to write in place of the model's and the optimizer's own (a sharded
    run's, gathered by every rank before the master writes)."""
    path = os.path.join(folder, f"{state.step}_checkpoint.pt")
    _atomic_save({"model": _cpu(model_sd if model_sd is not None
                                else state.model.state_dict()),
                  "optimizer": (optimizer_sd if optimizer_sd is not None
                                else state.optimizer.state_dict()),
                  "elb_t": float(state.elb_t), "step": int(state.step),
                  "epoch": int(state.epoch)}, path)
    return path


def find_last_checkpoint(folder: str) -> Tuple[Optional[int],
                                               Optional[dict]]:
    found = _steps(folder, _CKPT_RE)
    if not found:
        return None, None
    step, name = found[-1]
    return step, torch.load(os.path.join(folder, name), map_location="cpu",
                            weights_only=True)


def restore_checkpoint(state, payload: dict, load_optimizer=None) -> None:
    """Load a checkpoint payload into a TrainState in place;
    load_optimizer(optimizer_sd) replaces optimizer.load_state_dict."""
    state.model.load_state_dict(payload["model"])
    (load_optimizer or state.optimizer.load_state_dict)(payload["optimizer"])
    state.elb_t = float(payload["elb_t"])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])


def keep_last_n_checkpoints(folder: str, n: int) -> List[str]:
    """Prune older rolling checkpoints; returns the removed paths."""
    found = _steps(folder, _CKPT_RE)
    removed = []
    for _, f in (found[:-n] if n > 0 else found):
        p = os.path.join(folder, f)
        os.remove(p)
        removed.append(p)
    return removed


def split_by_component(state_dict: Dict[str, torch.Tensor]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """'encoder.layer1.0.conv1.weight' -> {'encoder': {'layer1.0...'}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in state_dict.items():
        comp, rest = k.split(".", 1)
        out.setdefault(comp, {})[rest] = v
    return out


def save_best_model(folder: str, step: int, model: nn.Module,
                    extra: Optional[dict] = None,
                    state_dict: Optional[dict] = None) -> str:
    """state_dict: the model's state to write (default its own)."""
    sd = state_dict if state_dict is not None else model.state_dict()
    payload = {"components": split_by_component(_cpu(sd)),
               "extra": dict(extra or {}, step=int(step))}
    path = os.path.join(folder, f"{step}_best_model.pt")
    _atomic_save(payload, path)
    for s, f in _steps(folder, _BEST_RE):
        if s != step:
            os.remove(os.path.join(folder, f))
    return path


def load_best_model(folder: str) -> Tuple[Optional[int], Optional[dict]]:
    found = _steps(folder, _BEST_RE)
    if not found:
        return None, None
    step, name = found[-1]
    return step, torch.load(os.path.join(folder, name), map_location="cpu",
                            weights_only=True)


def load_components(model: nn.Module, components: dict,
                    only: Optional[List[str]] = None) -> None:
    """Strict component-wise load: every key and shape of a loaded
    component must match the model's."""
    for comp, sd in components.items():
        if only is not None and comp not in only:
            continue
        sub = getattr(model, comp, None)
        if not isinstance(sub, nn.Module):
            raise KeyError(f"the model has no component {comp!r}")
        sub.load_state_dict(sd, strict=True)
