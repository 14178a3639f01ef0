"""Pseudo-label (seed) samplers, batched (port of cams/seeding.py
tcam_seeder and fcam_seeder).

Per sample: foreground seeds are drawn without replacement from the top
max_p fraction of CAM pixels (inside the ROI when use_roi), uniformly or
CAM-weighted; background seeds uniformly from the bottom min_p fraction;
both dilated by ksz, collisions cleared; output {1: fg, 0: bg, ignore};
constant CAMs seed nothing.  Sampling without replacement is the Gumbel
top-k trick, and the pools and large-k selections use the same multi-probe
bisection as the JAX seeder, so equal Gumbel noise gives equal masks.

fcam_seeder (F-CAM's MBSeederSLFCAMS): foreground seeds uniformly inside
the eroded STOtsu ROI of the CAM, background seeds uniformly in the
bottom min_p fraction.  As in the JAX package, the F_CL train step seeds
with tcam_seeder and the sl_tc_* keys; fcam_seeder has no caller on a
path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.ops import morphology
from tcam_wsol_video_tpu_torch.ops.otsu import otsu_threshold_batch

_BISECT_ITERS = 8
_BISECT_PROBES = 7
_BISECT_TOPK_THRESHOLD = 32
_BISECT_TOPK_ITERS = 8


def _bisect_threshold_rows(v: torch.Tensor, n: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor,
                           iters: int) -> torch.Tensor:
    """Largest t per row with count(v[r] >= t) >= n[r], to within
    (hi - lo) * 8^-iters; each pass tests _BISECT_PROBES interior points."""
    fr = (torch.arange(1, _BISECT_PROBES + 1, dtype=v.dtype,
                       device=v.device) / (_BISECT_PROBES + 1))
    for _ in range(iters):
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]
        counts = (v[:, None, :] >= mids[:, :, None]).sum(-1)
        keep = counts >= n[:, None]
        lo, hi = (torch.where(keep, mids, lo[:, None]).amax(1),
                  torch.where(keep, hi[:, None], mids).amin(1))
    return lo


def _top_fraction_mask_rows(v: torch.Tensor, n: torch.Tensor
                            ) -> torch.Tensor:
    """Row masks ~= "among the n[r] largest values of v[r]"."""
    lo_b = _bisect_threshold_rows(v, n, v.amin(1), v.amax(1), _BISECT_ITERS)
    return v >= lo_b[:, None]


def _gumbel_topk_bisect_rows(keys: torch.Tensor, eligible: torch.Tensor,
                             k: torch.Tensor) -> torch.Tensor:
    """Row-wise top-k of perturbed keys (-inf where ineligible) by
    bisection; k (R,).  Returns (R, P) int32 masks."""
    n = torch.minimum(k, eligible.sum(1))
    lo = torch.where(eligible, keys, float("inf")).amin(1)
    hi = torch.where(eligible, keys, float("-inf")).amax(1)
    lo_b = _bisect_threshold_rows(keys, n, lo, hi, _BISECT_TOPK_ITERS)
    mask = (keys >= lo_b[:, None]) & eligible & (n > 0)[:, None]
    return mask.to(torch.int32)


def _gumbel_topk_argmax_rows(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise top-k by k rounds of argmax (small k); keys (R, P) with
    -inf where ineligible.  Returns (R, P) int32 masks."""
    kc = keys.clone()
    mask = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for _ in range(k):
        # gathers and scatters on the card, no host value (CUDA graphs)
        i = kc.argmax(1, keepdim=True)
        hit = torch.isfinite(kc.gather(1, i))
        mask.scatter_(1, i, torch.where(hit, 1, mask.gather(1, i)))
        kc.scatter_(1, i, float("-inf"))
    return mask


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _select(keys: torch.Tensor, eligible: torch.Tensor, k: int
            ) -> torch.Tensor:
    """Row-wise Gumbel top-k masks (R, P) int32 of k static draws: k
    argmax rounds, or the bisection above _BISECT_TOPK_THRESHOLD."""
    if k > _BISECT_TOPK_THRESHOLD:
        return _gumbel_topk_bisect_rows(
            keys, eligible, torch.full((keys.shape[0],), k,
                                       dtype=torch.int32,
                                       device=keys.device))
    return _gumbel_topk_argmax_rows(keys, k)


def _finish_seeds(fg: torch.Tensor, bg: torch.Tensor, ksz: int,
                  ignore: int) -> torch.Tensor:
    """Dilate both seed masks by ksz, clear their collisions, and write
    {1: fg, 0: bg, ignore elsewhere}."""
    fg = morphology.dilate(fg, ksz)
    bg = morphology.dilate(bg, ksz)
    both = (fg + bg) == 2
    fg = torch.where(both, 0, fg)
    bg = torch.where(both, 0, bg)
    out = torch.full(fg.shape, ignore, dtype=torch.int32, device=fg.device)
    out = torch.where(fg == 1, 1, out)
    return torch.where(bg == 1, 0, out).to(torch.int32)


@dataclass(frozen=True)
class TCAMSeederCfg:
    seed_tech: str = constants.SEED_UNIFORM
    min_: int = 10           # bg samples
    max_: int = 10           # fg samples
    min_p: float = 0.2       # bottom fraction eligible for bg
    max_p: float = 0.2       # top fraction eligible for fg
    fg_erode_k: int = 11
    fg_erode_iter: int = 0
    ksz: int = 1             # seed dilation kernel
    seg_ignore_idx: int = constants.SEG_IGNORE_IDX
    use_roi: bool = False


def seeder_cfg_from_args(args) -> TCAMSeederCfg:
    return TCAMSeederCfg(
        seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
        max_=args.sl_tc_max, min_p=args.sl_tc_min_p, max_p=args.sl_tc_max_p,
        fg_erode_k=args.sl_tc_fg_erode_k,
        fg_erode_iter=args.sl_tc_fg_erode_iter, ksz=args.sl_tc_ksz,
        seg_ignore_idx=args.seg_ignore_idx, use_roi=args.sl_tc_use_roi)


def tcam_seeder(cams: torch.Tensor, cfg: TCAMSeederCfg,
                roi: Optional[torch.Tensor] = None,
                seed_tech: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cams (B, H, W) in [0, 1]; roi (B, H, W) binary or None.  gumbel
    (B, 2, H*W) gives the fg/bg Gumbel noise explicitly; otherwise it is
    drawn from `generator`.  Returns (B, H, W) int32 in {1, 0, ignore}."""
    b, h, w = cams.shape
    p = h * w
    dev = cams.device
    st = seed_tech or cfg.seed_tech
    if gumbel is None:
        gumbel = gumbel_noise((b, 2, p), generator, dev)
    flat = cams.reshape(b, p).float()
    degenerate = flat.amin(1) == flat.amax(1)

    # fg pool: top max_p fraction of the (roi-masked) cam
    if cfg.use_roi and roi is not None:
        roi_f = roi.float()
        if cfg.fg_erode_iter > 0:
            roi_f = morphology.erode(roi_f, cfg.fg_erode_k,
                                     cfg.fg_erode_iter)
        n_roi = roi_f.reshape(b, p).sum(1)
        cam_fg = flat * roi_f.reshape(b, p) + 1e-8
        n_fg = torch.floor(cfg.max_p * n_roi).to(torch.int32)
    else:
        cam_fg = flat + 1e-8
        n_fg = torch.full((b,), int(cfg.max_p * p), dtype=torch.int32,
                          device=dev)
    # bg pool: bottom min_p fraction of the full cam
    cam_bg = flat + 1e-8
    n_bg = torch.full((b,), int(cfg.min_p * p), dtype=torch.int32,
                      device=dev)

    # both pools through one row-batched bisection (top of -cam_bg =
    # bottom of cam_bg): rows (fg_0, bg_0, fg_1, bg_1, ...)
    elig = _top_fraction_mask_rows(
        torch.stack([cam_fg, -cam_bg], 1).reshape(2 * b, p),
        torch.stack([n_fg, n_bg], 1).reshape(2 * b)).reshape(b, 2, p)
    fg_elig = elig[:, 0] & (n_fg > 0)[:, None]
    bg_elig = elig[:, 1] & (n_bg > 0)[:, None]

    if st == constants.SEED_UNIFORM:
        logw_fg = torch.zeros_like(cam_fg)
    else:  # SEED_WEIGHTED: probabilities proportional to cam values
        logw_fg = torch.log(cam_fg.clamp_min(1e-20))

    k_fg = max(int(cfg.max_), 1)
    k_bg = max(int(cfg.min_), 1)
    keys = torch.stack([
        torch.where(fg_elig, logw_fg + gumbel[:, 0], float("-inf")),
        torch.where(bg_elig, gumbel[:, 1], float("-inf"))], 1)  # (B, 2, P)
    if max(k_fg, k_bg) > _BISECT_TOPK_THRESHOLD:
        k = torch.stack([
            torch.full((b,), k_fg, dtype=torch.int32, device=dev),
            torch.full((b,), k_bg, dtype=torch.int32, device=dev)],
            1).reshape(2 * b)
        sel = _gumbel_topk_bisect_rows(
            keys.reshape(2 * b, p),
            torch.stack([fg_elig, bg_elig], 1).reshape(2 * b, p), k)
        sel = sel.reshape(b, 2, p)
        fg, bg = sel[:, 0], sel[:, 1]
    else:
        fg = _gumbel_topk_argmax_rows(keys[:, 0], k_fg)
        bg = _gumbel_topk_argmax_rows(keys[:, 1], k_bg)
    if cfg.max_ <= 0:
        fg = torch.zeros_like(fg)
    if cfg.min_ <= 0:
        bg = torch.zeros_like(bg)

    # degenerate cams seed nothing
    fg = torch.where(degenerate[:, None], 0, fg).reshape(b, h, w)
    bg = torch.where(degenerate[:, None], 0, bg).reshape(b, h, w)

    return _finish_seeds(fg, bg, cfg.ksz, cfg.seg_ignore_idx)


@dataclass(frozen=True)
class FCAMSeederCfg:
    min_: int = 10           # bg samples
    max_: int = 10           # fg samples
    min_p: float = 0.2       # bottom fraction eligible for bg
    fg_erode_k: int = 11
    fg_erode_iter: int = 1
    ksz: int = 1             # seed dilation kernel
    seg_ignore_idx: int = constants.SEG_IGNORE_IDX


def fcam_seeder(cams: torch.Tensor, cfg: FCAMSeederCfg,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cams (B, H, W) in [0, 1] -> (B, H, W) int32 in {1, 0, ignore}.
    Foreground: max_ uniform draws inside the ROI floor(255 cam) >= its
    STOtsu threshold, eroded fg_erode_iter times by fg_erode_k;
    background: min_ uniform draws in the bottom min_p fraction of the
    CAM.  gumbel (B, 2, H*W) gives the fg/bg Gumbel noise explicitly;
    otherwise it is drawn from `generator`."""
    b, h, w = cams.shape
    p = h * w
    dev = cams.device
    if gumbel is None:
        gumbel = gumbel_noise((b, 2, p), generator, dev)
    q = torch.floor(cams * 255.0)
    roi = (q >= otsu_threshold_batch(cams)[:, None, None]).float()
    if cfg.fg_erode_iter > 0:
        roi = morphology.erode(roi, cfg.fg_erode_k, cfg.fg_erode_iter)
    fg_elig = roi.reshape(b, p) > 0
    fg = _select(torch.where(fg_elig, gumbel[:, 0], float("-inf")),
                 fg_elig, max(int(cfg.max_), 1))
    if cfg.max_ <= 0:
        fg = torch.zeros_like(fg)

    n_bg = int(cfg.min_p * p)
    bg_elig = _top_fraction_mask_rows(
        -(cams.reshape(b, p) + 1e-8),
        torch.full((b,), n_bg, dtype=torch.int32, device=dev)) & (n_bg > 0)
    bg = _select(torch.where(bg_elig, gumbel[:, 1], float("-inf")),
                 bg_elig, max(int(cfg.min_), 1))
    if cfg.min_ <= 0:
        bg = torch.zeros_like(bg)
    return _finish_seeds(fg.reshape(b, h, w), bg.reshape(b, h, w), cfg.ksz,
                         cfg.seg_ignore_idx)
