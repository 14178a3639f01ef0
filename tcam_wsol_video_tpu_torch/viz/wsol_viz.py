"""Visuals (port of viz/wsol_viz.py): CAM overlays, GT and predicted
boxes, the prediction sheets, the progress grid, the curves and the demo
video, with neither cv2 nor matplotlib.

- cam_overlay: the JET colour of each CAM value (cv2.applyColorMap's table,
  taken once into JET_RGB) blended with the image in float64, truncated to
  uint8, as JAX computes it.
- draw_boxes: cv2.rectangle's pixels at thickness 2: each side a band of
  three pixels centred on it between its corners, and each corner the
  cross of a filled circle of radius 1 (boxes may be clipped or
  degenerate).
- The figures: the panels JAX hands to matplotlib, composed edge to edge
  into one PNG (data/png.py), with the titles and tags matplotlib would
  draw in <figure>.png.txt beside it.  The curve plots draw their lines
  with a plain rasterizer and write the plotted values into that file.
  Matplotlib's frame and fonts are not reproduced.
- ordered_prediction_sheets: the per-IoU folders of rank-named sheets,
  ordered_iou_{sigma}.txt / .yaml (a flat YAML that PyYAML's safe_load
  reads as JAX's mapping) and the some_taux multi-panel sheets.
- build_demo_video: a Motion-JPEG AVI (RIFF, the frames as `00dc` chunks
  of `movi`, an `idx1` index); the frames are encoded by nvJPEG on the
  card and by libjpeg on the CPU.  JAX writes mp4v .mp4 through cv2.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.data import png
from tcam_wsol_video_tpu_torch.data.folds import dump_flat_mapping

GT_COLOR = (0, 255, 0)     # green
PRED_COLOR = (255, 0, 0)   # red

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET) as
# RGB, 256 x 3 bytes
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000")
JET_RGB = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)

# the curves' colours (matplotlib's first cycle colours)
_LINE_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44),
                (214, 39, 40), (148, 103, 189), (140, 86, 75))


def cam_overlay(raw_img: np.ndarray, cam: np.ndarray,
                alpha: float = 0.6) -> np.ndarray:
    """raw_img (H, W, 3) in [0, 255]; cam (H, W) in [0, 1] -> the heat-map
    blend, uint8."""
    img = np.clip(raw_img, 0, 255).astype(np.uint8)
    heat = JET_RGB[(np.clip(cam, 0, 1) * 255).astype(np.uint8)]
    return (alpha * img + (1 - alpha) * heat).astype(np.uint8)


def _rectangle_mask(h: int, w: int, x0: int, y0: int, x1: int,
                    y1: int) -> np.ndarray:
    """cv2.rectangle's pixels at thickness 2, inside an (h, w) image."""
    mask = np.zeros((h, w), bool)
    xa, xb = min(x0, x1), max(x0, x1)
    ya, yb = min(y0, y1), max(y0, y1)

    def fill(r0, r1, c0, c1):
        r0, r1 = max(r0, 0), min(r1, h - 1)
        c0, c1 = max(c0, 0), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            mask[r0:r1 + 1, c0:c1 + 1] = True

    if xa != xb:                       # the horizontal sides
        for y in (ya, yb):
            fill(y - 1, y + 1, xa, xb)
    if ya != yb:                       # the vertical sides
        for x in (xa, xb):
            fill(ya, yb, x - 1, x + 1)
    for x in (xa, xb):                 # the corners' caps
        for y in (ya, yb):
            fill(y - 1, y + 1, x, x)
            fill(y, y, x - 1, x + 1)
    return mask


def draw_boxes(img: np.ndarray, boxes: Sequence[Sequence[float]],
               color=GT_COLOR, thickness: int = 2) -> np.ndarray:
    """A copy of img (H, W, 3) uint8 with each box (x0, y0, x1, y1),
    rounded as JAX rounds it, drawn as cv2.rectangle draws it."""
    if thickness != 2:
        raise ValueError("only cv2.rectangle's thickness 2 is reproduced")
    out = img.copy()
    h, w = out.shape[:2]
    for b in boxes:
        x0, y0, x1, y1 = [int(round(v)) for v in b]
        out[_rectangle_mask(h, w, x0, y0, x1, y1)] = color
    return out


def caption_path(path: str) -> str:
    """The text file beside a figure: <path>.txt."""
    return path + ".txt"


def save_figure(path: str, rows: List[List[np.ndarray]],
                lines: Sequence[str]) -> None:
    """The panels (rows of equal-sized (H, W, 3) uint8 arrays) edge to edge
    as one PNG at path, and `lines` in the .txt beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png.write_png(path, np.concatenate(
        [np.concatenate(r, axis=1) for r in rows], axis=0))
    with open(caption_path(path), "w") as f:
        f.writelines(f"{ln}\n" for ln in lines)


def single_panel(raw_img: np.ndarray, cam: Optional[np.ndarray],
                 gt_boxes: Sequence, pred_boxes: Sequence,
                 alpha: float = 0.6) -> np.ndarray:
    """The image plot_single shows: the overlay (or the image), GT boxes
    in green, predicted ones in red."""
    img = np.clip(raw_img, 0, 255).astype(np.uint8)
    vis = cam_overlay(img, cam, alpha=alpha) if cam is not None else img
    vis = draw_boxes(vis, gt_boxes, GT_COLOR)
    return draw_boxes(vis, pred_boxes, PRED_COLOR)


def plot_single(raw_img: np.ndarray, cam: Optional[np.ndarray],
                gt_boxes: Sequence, pred_boxes: Sequence,
                path: str, tags: Optional[Dict] = None,
                alpha: float = 0.6) -> None:
    title = " ".join(f"{k}={v}" for k, v in tags.items()) if tags else ""
    save_figure(path, [[single_panel(raw_img, cam, gt_boxes, pred_boxes,
                                     alpha)]], [title])


def multiple_panels(raw_img: np.ndarray, cam: np.ndarray,
                    gt_boxes: Sequence, entries: List[Dict],
                    alpha: float = 0.6
                    ) -> Tuple[List[List[np.ndarray]], List[str]]:
    """plot_multiple's two rows of panels (row 0 the overlays with the
    boxes, row 1 the mask at each entry's tau with the same boxes) and
    the row-0 titles."""
    img = np.clip(raw_img, 0, 255).astype(np.uint8)
    top, bottom, titles = [], [], []
    for e in entries:
        vis = cam_overlay(img, cam, alpha=alpha)
        vis = draw_boxes(vis, gt_boxes, GT_COLOR)
        top.append(draw_boxes(vis, e.get("pred_boxes", []), PRED_COLOR))
        tag = f"sigma={e.get('sigma', '')} tau={e.get('tau', 0):.3f}"
        if "iou" in e:
            tag += f" iou={e['iou']:.2f}"
        titles.append(tag)
        mask = (cam >= e.get("tau", 0.5)).astype(np.float32)
        mvis = (0.5 * img + 0.5 * (mask[..., None] *
                                   np.asarray(PRED_COLOR))).astype(np.uint8)
        mvis = draw_boxes(mvis, gt_boxes, GT_COLOR)
        bottom.append(draw_boxes(mvis, e.get("pred_boxes", []), PRED_COLOR))
    return [top, bottom], titles


def plot_multiple(raw_img: np.ndarray, cam: np.ndarray,
                  gt_boxes: Sequence, entries: List[Dict],
                  path: str, alpha: float = 0.6) -> None:
    """entries: [{"pred_boxes": (P, 4), "tau", "sigma", "iou"}, ...]."""
    if not entries:
        raise ValueError("plot_multiple needs at least one entry")
    rows, titles = multiple_panels(raw_img, cam, gt_boxes, entries, alpha)
    save_figure(path, rows, titles)


def ordered_prediction_sheets(visuals: List[tuple],
                              best_tau_list: Sequence[float],
                              iou_threshold_list: Sequence[int],
                              multi_contour: bool,
                              out_dir: str,
                              alpha: float = 0.6
                              ) -> Dict[int, List[tuple]]:
    """visuals: [(image_id, raw_img, cam, gt_boxes), ...].  For each IoU
    threshold sigma, each image's best box at sigma's best tau; the images
    ranked by its IoU, best first, into <out_dir>/<sigma>/<rank>_<id>.png,
    ordered_iou_<sigma>.yaml and .txt; and one some_taux/<id>.png sheet an
    image across the sigmas.  Returns {sigma: [(image_id, iou), ...]}."""
    from tcam_wsol_video_tpu_torch.metrics.wsol import scoremap_to_boxes
    from tcam_wsol_video_tpu_torch.ops.boxes import iou_matrix_np

    per_image = []
    for iid, raw, cam, gt in visuals:
        boxes_per_tau, _ = scoremap_to_boxes(cam, list(best_tau_list),
                                             multi_contour)
        by_sigma = {}
        for k, sigma in enumerate(iou_threshold_list):
            boxes = np.asarray(boxes_per_tau[k], np.float64)
            iou = iou_matrix_np(boxes, np.asarray(gt, np.float64))
            flat = iou.max(axis=1) if iou.size else np.zeros(1)
            j = int(np.argmax(flat))
            by_sigma[sigma] = (boxes[j], float(flat[j]))
        per_image.append((iid, raw, cam, gt, by_sigma))

    ordered: Dict[int, List[tuple]] = {}
    for k, sigma in enumerate(iou_threshold_list):
        ranked = sorted(
            ((iid, by[sigma][1]) for iid, _, _, _, by in per_image),
            key=lambda t: t[1], reverse=True)
        ordered[sigma] = ranked
        sig_dir = os.path.join(out_dir, str(sigma))
        os.makedirs(sig_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"ordered_iou_{sigma}.yaml"),
                  "w") as f:
            f.write(dump_flat_mapping({iid: iou for iid, iou in ranked}))
        with open(os.path.join(out_dir, f"ordered_iou_{sigma}.txt"),
                  "w") as f:
            for iid, iou in ranked:
                f.write(f"{iid.replace('/', '_')}: {iou}\n")
        rank_of = {iid: r for r, (iid, _) in enumerate(ranked)}
        for iid, raw, cam, gt, by in per_image:
            box, iou = by[sigma]
            plot_single(raw, cam, gt, [box],
                        os.path.join(sig_dir, f"{rank_of[iid]:03d}_"
                                     f"{iid.replace('/', '_')}.png"),
                        tags={"iou": round(iou, 3),
                              "tau": round(best_tau_list[k], 3),
                              "sigma": sigma},
                        alpha=alpha)

    sheet_dir = os.path.join(out_dir, "some_taux")
    for iid, raw, cam, gt, by in per_image:
        entries = [{"pred_boxes": [by[s][0]], "tau": best_tau_list[k],
                    "sigma": s, "iou": by[s][1]}
                   for k, s in enumerate(iou_threshold_list)]
        plot_multiple(raw, cam, gt, entries,
                      os.path.join(sheet_dir,
                                   iid.replace("/", "_") + ".png"),
                      alpha=alpha)
    return ordered


def plot_progress_grid(raw_imgs: List[np.ndarray], cams: List[np.ndarray],
                       path: str, epoch: int) -> None:
    """One row of overlays of fixed frames, titled with the epoch."""
    if not raw_imgs:
        raise ValueError("plot_progress_grid needs at least one frame")
    save_figure(path, [[cam_overlay(img, cam)
                        for img, cam in zip(raw_imgs, cams)]],
                [f"epoch {epoch}"])


def _line(canvas: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
          color) -> None:
    """Bresenham's segment from p0 to p1 ((x, y) pixels), clipped."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx + dy
    h, w = canvas.shape[:2]
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            canvas[y0, x0] = color
        if x0 == x1 and y0 == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def curve_panel(series: List[Tuple[Sequence[float], Sequence[float]]],
                size: Tuple[int, int] = (240, 320),
                margin: int = 12) -> np.ndarray:
    """A white (H, W, 3) panel with a gray frame and each (xs, ys) series
    drawn as a polyline in its colour, the axes spanning the data."""
    h, w = size
    canvas = np.full((h, w, 3), 255, np.uint8)
    canvas[margin, margin:w - margin] = 160
    canvas[h - margin - 1, margin:w - margin] = 160
    canvas[margin:h - margin, margin] = 160
    canvas[margin:h - margin, w - margin - 1] = 160
    xs_all = [float(x) for xs, _ in series for x in xs]
    ys_all = [float(y) for _, ys in series for y in ys
              if np.isfinite(y)]
    if not xs_all or not ys_all:
        return canvas
    x_lo, x_hi = min(xs_all), max(xs_all)
    y_lo, y_hi = min(ys_all), max(ys_all)
    x_span = (x_hi - x_lo) or 1.0
    y_span = (y_hi - y_lo) or 1.0
    inner_w, inner_h = w - 2 * margin - 3, h - 2 * margin - 3

    def px(x, y):
        return (margin + 1 + int(round((x - x_lo) / x_span * inner_w)),
                h - margin - 2 - int(round((y - y_lo) / y_span * inner_h)))

    for i, (xs, ys) in enumerate(series):
        color = _LINE_COLORS[i % len(_LINE_COLORS)]
        pts = [px(float(x), float(y)) for x, y in zip(xs, ys)
               if np.isfinite(y)]
        for a, b in zip(pts[:1] + pts[:-1], pts):
            _line(canvas, a, b, color)
    return canvas


def _values(v) -> str:
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def plot_meter_curves(histories: Dict[str, List[float]], path: str) -> None:
    """One panel per metric, its history against the epoch."""
    if not histories:
        raise ValueError("plot_meter_curves needs at least one history")
    panels, lines = [], []
    for name, hist in histories.items():
        panels.append(curve_panel([(list(range(len(hist))), hist)]))
        lines.append(f"{name} (x: epoch): {_values(hist)}")
    save_figure(path, [panels], lines)


def plot_boxacc_curves(taus: Sequence[float], curves: Dict,
                       path: str) -> None:
    """BoxAcc (%) against tau, one line per IoU threshold."""
    series, lines = [], ["x: cam threshold tau, y: BoxAcc (%)",
                         f"tau: {_values(taus)}"]
    for sigma, acc in curves.items():
        if not isinstance(sigma, (int, np.integer)):
            continue
        series.append((taus, acc))
        lines.append(f"IoU {sigma}: {_values(acc)}")
    save_figure(path, [[curve_panel(series)]], lines)


def _avi_chunk(fourcc: bytes, body: bytes) -> bytes:
    pad = b"\0" if len(body) % 2 else b""
    return fourcc + struct.pack("<I", len(body)) + body + pad


def _avi_list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def write_mjpeg_avi(jpegs: List[bytes], path: str, w: int, h: int,
                    fps: int) -> None:
    """JPEG frames as a Motion-JPEG AVI with an idx1 index."""
    n = len(jpegs)
    biggest = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", 1000000 // max(fps, 1), biggest * fps, 0,
                       0x10, n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0,
                                      n, biggest, -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
                       0, 0, 0, 0)
    hdrl = _avi_list(b"hdrl", _avi_chunk(b"avih", avih) + _avi_list(
        b"strl", _avi_chunk(b"strh", strh) + _avi_chunk(b"strf", strf)))
    movi, index, offset = [], [], 4
    for j in jpegs:
        chunk = _avi_chunk(b"00dc", j)
        index.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))
        movi.append(chunk)
        offset += len(chunk)
    body = (b"AVI " + hdrl + _avi_list(b"movi", b"".join(movi))
            + _avi_chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def build_demo_video(frames: List[np.ndarray], path: str, fps: int = 8,
                     device="cpu", quality: int = 95) -> None:
    """RGB frames (H, W, 3) -> a Motion-JPEG AVI at path, each frame
    encoded by the device's image route (data/image_route.py)."""
    from tcam_wsol_video_tpu_torch.data.image_route import route_for
    if not frames:
        raise ValueError("a demo video needs at least one frame")
    h, w = frames[0].shape[:2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    codec = route_for(device)
    jpegs = [codec.encode(np.clip(f, 0, 255).astype(np.uint8), quality,
                          device) for f in frames]
    write_mjpeg_avi(jpegs, path, w, h, fps)
