"""The exact all-threshold box sweep of the evaluation protocol on tensors
(port of metrics/device_sweep.py; eval_sweep=device).

The protocol renders each CAM to uint8 ((cam 255) truncated) and
thresholds it at int(tau max) with a strict >, so the ~1000 taus collapse
onto at most 256 binarizations.  For each level t and IoU threshold s this
computes whether any protocol contour box (outer, or the inner box of a
hole) of q > t reaches IoU >= s / 100 against a valid GT box; the host maps
each tau to its level (metrics/wsol.BoxEvaluator.accumulate_level_hits), so
the counters are bit-equal to the host sweep's (metrics/native_sweep).

Algorithm (JAX's, in stock torch ops):
1. each level's mask is cut into horizontal runs, max_runs slots a row; an
   image with a row of more runs at some level raises its fallback bit,
   and the evaluator sweeps that image on the host;
2. components live on the run graph (runs of adjacent rows overlapping
   under the dilation: 1 for the 8-connected foreground, 0 for the
   4-connected background); each run's (x0, y, -x1, -y) relaxes to its
   component's minimum by top-down and bottom-up row sweeps, repeated
   until nothing changes;
3. holes are background components off the border, their box dilated by 1
   and clamped;
4. an empty level gives the protocol's one [0, 0, 0, 0] box;
5. the IoU test is integer: 100 inter >= s union, union > 0.

Images are independent, so a batch runs in groups that bound the
temporaries (256 levels x H x W a image).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_INF = 1 << 30
# elements of one (levels x images x H x W) temporary per group
_GROUP_ELEMS = 1 << 29


def _extract_runs(masks: torch.Tensor, max_runs: int):
    """masks (N, H, W) bool -> (x0, x1 (N, H, R) int32 start and end
    column of each row's runs, left to right; valid (N, H, R); overflow
    (N,): some row has more than max_runs runs)."""
    n, h, w = masks.shape
    left = torch.cat([torch.zeros((n, h, 1), dtype=torch.bool,
                                  device=masks.device), masks[:, :, :-1]], 2)
    start = masks & ~left
    sid = torch.cumsum(start, -1, dtype=torch.int16) - 1
    overflow = ((sid >= max_runs) & masks).flatten(1).any(1)
    xs = torch.arange(w, dtype=torch.int32, device=masks.device)
    x0r, x1r = [], []
    for r in range(max_runs):
        sel = masks & (sid == r)
        x0r.append(torch.where(sel, xs, _INF).amin(-1))
        x1r.append(torch.where(sel, xs, -1).amax(-1))
    x0r = torch.stack(x0r, -1)
    x1r = torch.stack(x1r, -1)
    return x0r, x1r, x1r >= 0, overflow


def _interval_cc(x0r: torch.Tensor, x1r: torch.Tensor, valid: torch.Tensor,
                 dilate: int, border: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The fixpoint of the runs' (x0, y, -x1, -y[, -border]) under the
    minimum over the run graph: every run ends with its component's
    minima, i.e. its box (and whether any of its runs touches the border).
    Returns (N, C, H, R) int32."""
    n, h, r = x0r.shape
    ys = torch.arange(h, dtype=torch.int32, device=x0r.device)[None, :, None
                                                               ].expand(n, h, r)
    inf = torch.full((), _INF, dtype=torch.int32, device=x0r.device)
    chans = [torch.where(valid, x0r, inf), torch.where(valid, ys, inf),
             torch.where(valid, -x1r, inf), torch.where(valid, -ys, inf)]
    if border is not None:
        chans.append(torch.where(valid, -border.to(torch.int32), inf))
    state = torch.stack(chans, 1)                          # (N, C, H, R)

    # run i of row y ~ run j of row y - 1 where the dilated intervals meet
    a0 = x0r - dilate
    a1 = x1r + dilate
    up_x0 = torch.cat([torch.zeros_like(x0r[:, :1]), x0r[:, :-1]], 1)
    up_x1 = torch.cat([torch.full_like(x1r[:, :1], -1), x1r[:, :-1]], 1)
    up_v = torch.cat([torch.zeros_like(valid[:, :1]), valid[:, :-1]], 1)
    ov_up = (valid[..., :, None] & up_v[..., None, :]
             & (a0[..., :, None] <= up_x1[..., None, :])
             & (a1[..., :, None] >= up_x0[..., None, :]))  # (N, H, R, R)
    ovu = ov_up.permute(1, 0, 2, 3)                         # (H, N, R, R)
    st = state.permute(2, 0, 1, 3).contiguous()             # (H, N, C, R)

    while True:
        new = st.clone()
        for y in range(1, h):           # top-down: row y from row y - 1
            nb = torch.where(ovu[y][:, None], new[y - 1][:, :, None, :], inf)
            new[y] = torch.minimum(new[y], nb.amin(-1))
        for y in range(h - 2, -1, -1):  # bottom-up: row y from row y + 1
            nb = torch.where(ovu[y + 1][:, None], new[y + 1][:, :, :, None],
                             inf)
            new[y] = torch.minimum(new[y], nb.amin(2))
        changed = bool((new != st).any())
        st = new
        if not changed:
            break
    return st.permute(1, 2, 0, 3)                           # (N, C, H, R)


def _hits_from_runs(x0, y0, x1, y1, ok, gt, gt_valid,
                    sigmas100: Sequence[int]) -> torch.Tensor:
    """Boxes (N, H, R) int32 where ok, against GT (N, G, 4) int32 where
    gt_valid (N, G) -> (N, S) bool: some pair with union > 0 and
    100 inter >= s union."""
    gx0, gy0, gx1, gy1 = (gt[:, None, None, :, i] for i in range(4))
    x0, y0, x1, y1 = (v[..., None] for v in (x0, y0, x1, y1))
    iw = torch.minimum(x1, gx1) - torch.maximum(x0, gx0) + 1
    ih = torch.minimum(y1, gy1) - torch.maximum(y0, gy0) + 1
    inter = iw.clamp_min(0) * ih.clamp_min(0)               # (N, H, R, G)
    area = (x1 - x0 + 1) * (y1 - y0 + 1)
    garea = (gx1 - gx0 + 1) * (gy1 - gy0 + 1)
    union = area + garea - inter
    okg = ok[..., None] & gt_valid[:, None, None, :] & (union > 0)
    return torch.stack([(okg & (100 * inter >= s * union)).flatten(1).any(1)
                        for s in sigmas100], -1)


def _empty_level_hits(gt, gt_valid, sigmas100) -> torch.Tensor:
    """The protocol's no-contour box [0, 0, 0, 0] against the GT: (B, S)."""
    b = gt.shape[0]
    z = torch.zeros((b, 1, 1), dtype=torch.int32, device=gt.device)
    ok = torch.ones((b, 1, 1), dtype=torch.bool, device=gt.device)
    return _hits_from_runs(z, z, z, z, ok, gt, gt_valid, sigmas100)


def _level_hits_group(q, gt, gt_valid, sigmas100, max_runs):
    b, h, w = q.shape
    qi = q.to(torch.int32)
    s = len(sigmas100)

    # foreground: q > t for t = 0..254, 8-connected
    levels = torch.arange(255, dtype=torch.int32, device=q.device)
    fg = (qi[None] > levels[:, None, None, None]).reshape(255 * b, h, w)
    fx0, fx1, fvalid, f_over = _extract_runs(fg, max_runs)
    del fg
    fst = _interval_cc(fx0, fx1, fvalid, dilate=1)
    cx0, cy0 = fst[:, 0], fst[:, 1]
    cx1 = torch.clamp(-fst[:, 2] + 1, max=w - 1)
    cy1 = torch.clamp(-fst[:, 3] + 1, max=h - 1)
    gt_f = gt[None].expand(255, *gt.shape).reshape(255 * b, *gt.shape[1:])
    gv_f = gt_valid[None].expand(255, *gt_valid.shape).reshape(
        255 * b, gt_valid.shape[1])
    fg_hits = _hits_from_runs(cx0, cy0, cx1, cy1, fvalid, gt_f, gv_f,
                              sigmas100).reshape(255, b, s)
    fg_any = fvalid.flatten(1).any(1).reshape(255, b)
    del fst

    # background (holes): q <= t for t = 0..255, 4-connected
    levels_bg = torch.arange(256, dtype=torch.int32, device=q.device)
    bgm = (qi[None] <= levels_bg[:, None, None, None]).reshape(256 * b, h, w)
    bx0, bx1, bvalid, b_over = _extract_runs(bgm, max_runs)
    del bgm
    ys = torch.arange(h, dtype=torch.int32, device=q.device)[None, :, None]
    border = ((ys == 0) | (ys == h - 1) | (bx0 == 0) | (bx1 == w - 1)) & bvalid
    bst = _interval_cc(bx0, bx1, bvalid, dilate=0, border=border)
    is_hole = bvalid & (bst[:, 4] == 0)
    hx0 = bst[:, 0] - 1
    hy0 = bst[:, 1] - 1
    hx1 = torch.clamp(-bst[:, 2] + 2, max=w - 1)
    hy1 = torch.clamp(-bst[:, 3] + 2, max=h - 1)
    gt_b = gt[None].expand(256, *gt.shape).reshape(256 * b, *gt.shape[1:])
    gv_b = gt_valid[None].expand(256, *gt_valid.shape).reshape(
        256 * b, gt_valid.shape[1])
    hole_hits = _hits_from_runs(hx0, hy0, hx1, hy1, is_hole, gt_b, gv_b,
                                sigmas100).reshape(256, b, s)

    empty = _empty_level_hits(gt, gt_valid, sigmas100)     # (B, S)
    combined = torch.where(fg_any[..., None], fg_hits | hole_hits[:255],
                           empty[None])
    hits = torch.cat([combined, empty[None]], 0)           # (256, B, S)
    peak = qi.flatten(1).amax(1)
    fallback = (f_over.reshape(255, b).any(0)
                | b_over.reshape(256, b).any(0))
    return hits.permute(1, 0, 2), peak, fallback


def level_hits(q: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
               sigmas100: Sequence[int], max_runs: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, H, W) uint8 rendered CAMs, gt (B, G, 4) int32, gt_valid (B, G)
    bool, sigmas100 e.g. (30, 50, 70).  Returns (hits (B, 256, S) bool: at
    level t some protocol box of q > t reaches IoU >= s / 100 against a
    valid GT box; peak (B,) int32 = q.max() for the host's int(tau peak);
    fallback (B,) bool: a level of the image overflowed max_runs, its
    hits are not exact and the image must be swept on the host)."""
    b, h, w = q.shape
    group = max(1, _GROUP_ELEMS // (256 * h * w))
    outs = [_level_hits_group(q[i:i + group], gt[i:i + group].to(torch.int32),
                              gt_valid[i:i + group], tuple(sigmas100),
                              max_runs)
            for i in range(0, b, group)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def render_uint8(cam: torch.Tensor) -> torch.Tensor:
    """The protocol's rendering of CAMs in [0, 1]: (cam 255) truncated to
    uint8; a uint16 eval_transfer CAM (k 257) gives k back; uint8 is
    returned as it is."""
    if cam.dtype == torch.uint8:
        return cam
    if cam.dtype == torch.uint16:
        return (cam.to(torch.int32) * 255 // 65535).to(torch.uint8)
    return (cam.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def sweep_batch(cams: torch.Tensor, gt_boxes: np.ndarray,
                gt_valid: np.ndarray, sigmas100: Sequence[int],
                max_runs: int = 8):
    """The evaluator's entry: cams (B, H, W) on their device in any
    eval_transfer dtype, host GT boxes (B, G, 4) and mask (B, G) -> the
    device tensors of level_hits."""
    q = render_uint8(cams)
    gt = torch.from_numpy(np.asarray(gt_boxes, np.int64).astype(np.int32))
    gv = torch.from_numpy(np.asarray(gt_valid, bool))
    return level_hits(q, gt.to(q.device), gv.to(q.device),
                      tuple(int(s) for s in sigmas100), max_runs=max_runs)
