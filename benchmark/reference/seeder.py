"""TCAM's seed sampler (a frozen copy of the JAX package's recipe).

Per sample: foreground seeds are drawn without replacement from the top
max_p fraction of CAM pixels inside the ROI, CAM-weighted (seed_weighted)
or uniformly; background seeds uniformly from the bottom min_p fraction of
the CAM; both dilated by ksz, collisions cleared; {1: fg, 0: bg, ignore}.
A constant CAM seeds nothing.  Drawing without replacement is the Gumbel
top-k trick on the given noise; the pools come from an 8-pass, 7-probe
bisection of the count threshold (the recipe's approximation, kept so that
equal noise gives equal seeds)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

BISECT_ITERS = 8
BISECT_PROBES = 7
BISECT_TOPK_THRESHOLD = 32


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1) from `generator`."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _bisect_rows(v, n, lo, hi, iters):
    """Largest t per row with count(v[r] >= t) >= n[r] (to the bisection's
    resolution)."""
    fr = (torch.arange(1, BISECT_PROBES + 1, dtype=v.dtype, device=v.device)
          / (BISECT_PROBES + 1))
    for _ in range(iters):
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]
        keep = (v[:, None, :] >= mids[:, :, None]).sum(-1) >= n[:, None]
        lo, hi = (torch.where(keep, mids, lo[:, None]).amax(1),
                  torch.where(keep, hi[:, None], mids).amin(1))
    return lo


def _topk_by_bisection(keys, eligible, k):
    n = torch.minimum(k, eligible.sum(1))
    lo = torch.where(eligible, keys, float("inf")).amin(1)
    hi = torch.where(eligible, keys, float("-inf")).amax(1)
    t = _bisect_rows(keys, n, lo, hi, BISECT_ITERS)
    return ((keys >= t[:, None]) & eligible & (n > 0)[:, None]).to(
        torch.int32)


def _topk_by_argmax(keys, k: int):
    kc = keys.clone()
    mask = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for _ in range(k):
        i = kc.argmax(1, keepdim=True)
        hit = torch.isfinite(kc.gather(1, i))
        mask.scatter_(1, i, torch.where(hit, 1, mask.gather(1, i)))
        kc.scatter_(1, i, float("-inf"))
    return mask


def _dilate(x: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 1:
        return x
    lead = x.shape[:-2]
    y = x.float().reshape((-1, 1) + tuple(x.shape[-2:]))
    lo, hi = (k - 1) // 2, k // 2
    y = F.max_pool2d(F.pad(y, (lo, hi, lo, hi), value=float("-inf")), k,
                     stride=1)
    return y.reshape(lead + y.shape[-2:]).to(x.dtype)


def seeds(cams: torch.Tensor, roi, gumbel: torch.Tensor, cfg: dict,
          weighted: bool) -> torch.Tensor:
    """cams (B, H, W) in [0, 1], roi (B, H, W) or None, gumbel (B, 2, HW);
    cfg: n_fg, n_bg, max_p, min_p, ksz, ignore."""
    b, h, w = cams.shape
    p = h * w
    flat = cams.reshape(b, p).float()
    degenerate = flat.amin(1) == flat.amax(1)
    if roi is not None:
        roi_f = roi.float().reshape(b, p)
        cam_fg = flat * roi_f + 1e-8
        n_fg = torch.floor(cfg["max_p"] * roi_f.sum(1)).to(torch.int32)
    else:
        cam_fg = flat + 1e-8
        n_fg = torch.full((b,), int(cfg["max_p"] * p), dtype=torch.int32,
                          device=cams.device)
    cam_bg = flat + 1e-8
    n_bg = torch.full((b,), int(cfg["min_p"] * p), dtype=torch.int32,
                      device=cams.device)
    v = torch.stack([cam_fg, -cam_bg], 1).reshape(2 * b, p)
    n = torch.stack([n_fg, n_bg], 1).reshape(2 * b)
    elig = (v >= _bisect_rows(v, n, v.amin(1), v.amax(1),
                              BISECT_ITERS)[:, None]).reshape(b, 2, p)
    fg_elig = elig[:, 0] & (n_fg > 0)[:, None]
    bg_elig = elig[:, 1] & (n_bg > 0)[:, None]
    logw = (torch.log(cam_fg.clamp_min(1e-20)) if weighted
            else torch.zeros_like(cam_fg))
    k_fg, k_bg = max(int(cfg["n_fg"]), 1), max(int(cfg["n_bg"]), 1)
    keys = torch.stack([
        torch.where(fg_elig, logw + gumbel[:, 0], float("-inf")),
        torch.where(bg_elig, gumbel[:, 1], float("-inf"))], 1)
    if max(k_fg, k_bg) > BISECT_TOPK_THRESHOLD:
        k = torch.tensor([k_fg, k_bg], dtype=torch.int32,
                         device=cams.device).repeat(b)
        sel = _topk_by_bisection(
            keys.reshape(2 * b, p),
            torch.stack([fg_elig, bg_elig], 1).reshape(2 * b, p),
            k).reshape(b, 2, p)
        fg, bg = sel[:, 0], sel[:, 1]
    else:
        fg = _topk_by_argmax(keys[:, 0], k_fg)
        bg = _topk_by_argmax(keys[:, 1], k_bg)
    if cfg["n_fg"] <= 0:
        fg = torch.zeros_like(fg)
    if cfg["n_bg"] <= 0:
        bg = torch.zeros_like(bg)
    fg = torch.where(degenerate[:, None], 0, fg).reshape(b, h, w)
    bg = torch.where(degenerate[:, None], 0, bg).reshape(b, h, w)
    fg, bg = _dilate(fg, cfg["ksz"]), _dilate(bg, cfg["ksz"])
    both = (fg + bg) == 2
    fg = torch.where(both, 0, fg)
    bg = torch.where(both, 0, bg)
    out = torch.full(fg.shape, cfg["ignore"], dtype=torch.int32,
                     device=cams.device)
    out = torch.where(fg == 1, 1, out)
    return torch.where(bg == 1, 0, out).to(torch.int32)
