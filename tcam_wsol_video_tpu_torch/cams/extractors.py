"""CAM extractors of the TCAM eval path (port of cams/extractors.py)."""
from __future__ import annotations

import torch


def normalize_minmax(cam: torch.Tensor) -> torch.Tensor:
    """Per-map min-max normalization over the last two axes."""
    mn = cam.amin(dim=(-2, -1), keepdim=True)
    mx = cam.amax(dim=(-2, -1), keepdim=True)
    return (cam - mn) / (mx - mn)


def seg_cam(fcams: torch.Tensor) -> torch.Tensor:
    """Softmax foreground channel of the 2-channel decoder output.
    fcams (B, H, W, 2) -> (B, H, W)."""
    return torch.softmax(fcams, dim=-1)[..., 1]
