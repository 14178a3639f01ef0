"""Differentiable box -> foreground/background soft masks of the C_BOX
task, and the blurred composites its frozen classifier scores (port of
ops/box_stats.py).

A box is the raw scores (x1, y1, x2, y2) over scale_domain.  As in the
reference and the JAX package, x binds the HEIGHT axis and y the WIDTH
axis.  validity: x2 > x1, y2 > y1, inside the image; area (x2 - x1)
(y2 - y1); the fg mask is the product of the relu'd signed distances to
the four edges over the product of their magnitudes (1 inside, 0 outside,
gradients reach the box through the numerator); the bg mask its sum-form
analogue, 1 outside and 0 inside.  The denominators carry no gradient,
and where one is 0 (a pixel on an edge) the mask is its numerator; the
division then goes through a denominator of 1, so the backward stays
finite there.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def box_validity(x: Tensor, y: Tensor, h: int, w: int) -> Tensor:
    """x, y (B, 2) lo/hi pairs -> (B,) float32, 1 for a valid box."""
    v = (x[:, 1] > x[:, 0]).float()
    v = v * (y[:, 1] > y[:, 0])
    v = v * (x[:, 0] >= 0) * (x[:, 1] < h)
    return v * (y[:, 0] >= 0) * (y[:, 1] < w)


def box_area(x: Tensor, y: Tensor) -> Tensor:
    return (x[:, 1] - x[:, 0]) * (y[:, 1] - y[:, 0])


def _grids(h: int, w: int, device) -> Tuple[Tensor, Tensor]:
    gh = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    gw = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return gh.expand(h, w), gw.expand(h, w)


def _ratio(num: Tensor, den: Tensor) -> Tensor:
    """num / den where den > 0, else num; den carries no gradient."""
    den = den.detach()
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), num)


def mask_fg(x: Tensor, y: Tensor, h: int, w: int) -> Tensor:
    """(B, 2), (B, 2) -> (B, h, w) soft inside-box mask."""
    gh, gw = _grids(h, w, x.device)
    x1 = gh[None] - x[:, 0, None, None]
    x2 = x[:, 1, None, None] - gh[None]
    y1 = gw[None] - y[:, 0, None, None]
    y2 = y[:, 1, None, None] - gw[None]
    delta = x1.abs() * x2.abs() * y1.abs() * y2.abs()
    phi = F.relu(x1) * F.relu(x2) * F.relu(y1) * F.relu(y2)
    return _ratio(phi, delta)


def mask_bg(x: Tensor, y: Tensor, h: int, w: int) -> Tensor:
    """(B, 2), (B, 2) -> (B, h, w) soft outside-box mask."""
    gh, gw = _grids(h, w, x.device)
    x1 = x[:, 0, None, None] - gh[None]
    x2 = gh[None] - x[:, 1, None, None]
    y1 = y[:, 0, None, None] - gw[None]
    y2 = gw[None] - y[:, 1, None, None]
    delta = ((x1 > 0) * x1.abs() + (x2 > 0) * x2.abs()
             + (y1 > 0) * y1.abs() + (y2 > 0) * y2.abs())
    psi = F.relu(x1) + F.relu(x2) + F.relu(y1) + F.relu(y2)
    return _ratio(psi, delta)


def _clip(v: Tensor, hi: float) -> Tensor:
    """v clipped to [0, hi] as jnp.clip's minimum(maximum(.)): a value on
    a bound passes half its gradient."""
    return torch.minimum(torch.maximum(v, torch.zeros_like(v)),
                         torch.full_like(v, hi))


def box_stats(box: Tensor, h: int, w: int, scale_domain: float = 1.0,
              eval_mode: bool = False
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """box (B, 4) raw scores (x1, y1, x2, y2) -> (x, y, valid, area,
    mask_fg, mask_bg); eval_mode clamps the box into the image first."""
    x = torch.stack([box[:, 0], box[:, 2]], 1) / scale_domain
    y = torch.stack([box[:, 1], box[:, 3]], 1) / scale_domain
    if eval_mode:
        x = _clip(x, h - 1.0)
        y = _clip(y, w - 1.0)
    return (x, y, box_validity(x, y, h, w), box_area(x, y),
            mask_fg(x, y, h, w), mask_bg(x, y, h, w))


def gaussian_kernel(ksize: int, sigma: float, device=None) -> Tensor:
    """The normalized 1-D Gaussian of ksize taps (ksize // 2 each side)."""
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(images: Tensor, ksize: int = 31, sigma: float = 16.0
                  ) -> Tensor:
    """Separable Gaussian blur of (B, H, W, C) images, zero-padded to the
    same size: along H, then along W (one grouped convolution each, NCHW
    inside)."""
    c = images.shape[-1]
    r = ksize // 2
    k = gaussian_kernel(ksize, sigma, images.device).to(images.dtype)
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, k.view(1, 1, -1, 1).repeat(c, 1, 1, 1),
                 padding=(r, 0), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, -1).repeat(c, 1, 1, 1),
                 padding=(0, r), groups=c)
    return x.permute(0, 2, 3, 1)


def compose_fg_image(images: Tensor, blurred: Tensor, m_fg: Tensor,
                     m_bg: Tensor) -> Tensor:
    """The box kept, its outside blurred: m_fg image + m_bg blurred."""
    return m_fg[..., None] * images + m_bg[..., None] * blurred


def compose_bg_image(images: Tensor, blurred: Tensor, m_fg: Tensor,
                     m_bg: Tensor) -> Tensor:
    """The box blurred, its outside kept: m_bg image + m_fg blurred."""
    return m_bg[..., None] * images + m_fg[..., None] * blurred
