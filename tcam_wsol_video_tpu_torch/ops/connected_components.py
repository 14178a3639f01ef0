"""Connected components of binary maps (port of ops/connected_components.py):
the exact host labeling, and a batched tensor labeling for the device ROI.

`label_np` is scipy's 4-connected labeling (skimage.measure.label with
connectivity 1, the reference ROI's).  `label` labels a batch by min
propagation: each foreground pixel starts at its flat index + 1 and takes
the minimum over its 4-neighbourhood, num_iters times.  A component
converges once num_iters reaches its longest in-component geodesic path;
JAX fixes num_iters at 128, and so does the port, so that both give the
same labels on long spirals too, where neither is scipy's answer.
`component_stats` ranks the labels into 64 slots.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage as ndi

_FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.int32)


def label_np(mask: np.ndarray) -> np.ndarray:
    """Exact 4-connected labeling of an (H, W) mask (background 0)."""
    lab, _ = ndi.label(np.asarray(mask) > 0, structure=_FOUR)
    return lab


def label(mask: torch.Tensor, num_iters: int = 128) -> torch.Tensor:
    """4-connected labels of masks (B, H, W) -> (B, H, W) int64: each
    component carries the min flat index of its pixels + 1 once converged
    (see the module's note on num_iters); background is 0."""
    b, h, w = mask.shape
    fg = mask > 0
    big = h * w + 1
    idx = torch.arange(1, h * w + 1, device=mask.device).reshape(1, h, w)
    lab = torch.where(fg, idx, big)
    for _ in range(num_iters):
        p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
        n = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                          torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        lab = torch.where(fg, torch.minimum(lab, n), big)
    return torch.where(fg, lab, 0)


def component_stats(lab: torch.Tensor, cam: torch.Tensor,
                    max_components: int = 64):
    """Per-component area and CAM mass of labeled maps lab (B, H, W).

    Components are ranked by label into max_components slots, as JAX's
    jnp.unique(size=max_components + 1) ranks them: the rank of a label
    among the map's distinct values (background 0 included, when present,
    at rank 0), less one when background is present.  Past the
    (max_components + 1)-th distinct value a component gets no slot;
    without background the (max_components + 1)-th merges into the last
    slot.  Returns (areas (B, max_components) float32, masses
    (B, max_components) float32, comp (B, H, W) int64 slot of each pixel,
    -1 for background and slotless components)."""
    b, h, w = lab.shape
    flat = lab.reshape(b, h * w)
    fg = flat > 0
    present = torch.zeros((b, h * w + 1), dtype=torch.int64,
                          device=lab.device)
    present.scatter_(1, flat, 1)
    # rank of each value among the map's distinct values
    pos = (present.cumsum(1) - 1).gather(1, flat)
    n_lead = present[:, :1]         # 1 iff background occupies rank 0
    kept = pos <= max_components
    comp = torch.where(fg & kept, pos - n_lead, -1)
    comp = comp.clamp(-1, max_components - 1)
    valid = comp >= 0
    safe = torch.where(valid, comp, 0)
    areas = torch.zeros((b, max_components), dtype=torch.float32,
                        device=lab.device)
    masses = torch.zeros_like(areas)
    areas.scatter_add_(1, safe, valid.to(torch.float32))
    masses.scatter_add_(1, safe, torch.where(
        valid, cam.reshape(b, h * w).to(torch.float32), 0.0))
    return areas, masses, comp.reshape(b, h, w)
