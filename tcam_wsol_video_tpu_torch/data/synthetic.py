"""Synthetic video WSOL dataset: classes x videos x shots x frames with a
drifting coloured square whose box is known (port of data/synthetic.py).

It writes real JPEG frames (quality 95) and the wsol-done-right folds, so
the data -> model -> CAM -> metric path runs without YouTube-Objects on
disk: train ids are shot directories, eval ids are frames.  The tree, the
folds files and the random draws are the JAX generator's for the same
arguments.  The JPEGs are written by the device's image route
(data/image_route.py): libjpeg on the host for a CPU device, nvJPEG on
the card for a CUDA device.  `make_stand_in_cam_store` writes a
CAM store that stands in for a stage-1 classifier's (the GT box blurred,
plus noise).
"""
from __future__ import annotations

import colorsys
import os
from typing import Dict, List, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.folds import load_split_metadata
from tcam_wsol_video_tpu_torch.data.image_route import route_for

JPEG_QUALITY = 95


def encode_jpeg(img: np.ndarray, device="cuda",
                quality: int = JPEG_QUALITY) -> bytes:
    """(h, w, 3) uint8 RGB -> baseline JPEG bytes, by the device's image
    route."""
    return route_for(device).encode(img, quality, device)


def write_jpeg(path: str, img: np.ndarray, device="cuda",
               quality: int = JPEG_QUALITY) -> None:
    """(h, w, 3) uint8 RGB -> a baseline JPEG file, by the device's image
    route."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, device, quality))


def _draw_frame(h: int, w: int, box: Tuple[int, int, int, int],
                color: Tuple[int, int, int], rng) -> np.ndarray:
    img = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    x0, y0, x1, y1 = box
    img[y0:y1 + 1, x0:x1 + 1] = np.asarray(color, np.uint8)
    return img


def make_synthetic_dataset(root: str, n_classes: int = 3,
                           n_videos_per_class: int = 2,
                           n_shots_per_video: int = 2,
                           n_frames_per_shot: int = 4,
                           frame_hw: Tuple[int, int] = (90, 120),
                           seed: int = 0, device="cuda",
                           keep_frames: int = 0) -> Dict[str, object]:
    """Returns {'data_root', 'metadata_root', 'parent'} and, with
    keep_frames > 0, 'frames': {frame id: source array} of the first
    keep_frames frames written."""
    rng = np.random.default_rng(seed)
    h, w = frame_hw
    data_root = os.path.join(root, "data")
    meta_root = os.path.join(root, "folds")
    classes = [f"class{i}" for i in range(n_classes)]
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220),
              (220, 220, 40), (220, 40, 220)]
    for i in range(len(colors), n_classes):
        # procedural hues keep every class separable at YTOv1's 10 classes
        r, g, b = colorsys.hsv_to_rgb((i + 0.5) / n_classes, 0.85, 0.8)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))

    train_ids: List[str] = []
    train_labels: List[str] = []
    eval_rows: Dict[str, List[str]] = {k: [] for k in
                                       ("ids", "labels", "sizes", "locs")}
    kept: Dict[str, np.ndarray] = {}
    for ci, cname in enumerate(classes):
        color = colors[ci % len(colors)]
        for vi in range(n_videos_per_class):
            for si in range(n_shots_per_video):
                shot = f"{cname}/data/{vi:04d}/shots/{si:03d}"
                shot_dir = os.path.join(data_root, shot)
                os.makedirs(shot_dir, exist_ok=True)
                bw, bh = int(w * 0.3), int(h * 0.3)
                x0 = int(rng.integers(0, w - bw - n_frames_per_shot * 2))
                y0 = int(rng.integers(0, h - bh - 2))
                for fi in range(n_frames_per_shot):
                    bx0 = x0 + 2 * fi          # the square drifts right
                    box = (bx0, y0, bx0 + bw, y0 + bh)
                    img = _draw_frame(h, w, box, color, rng)
                    fname = f"frame{fi:04d}.jpg"
                    write_jpeg(os.path.join(shot_dir, fname), img, device)
                    fid = f"{shot}/{fname}"
                    if len(kept) < keep_frames:
                        kept[fid] = img
                    eval_rows["ids"].append(fid)
                    eval_rows["labels"].append(f"{fid},{ci}")
                    eval_rows["sizes"].append(f"{fid},{w},{h}")
                    eval_rows["locs"].append(
                        f"{fid},{box[0]},{box[1]},{box[2]},{box[3]}")
                train_ids.append(shot)
                train_labels.append(f"{shot},{ci}")

    def write(split: str, ids: List[str], labels: List[str],
              sizes: List[str], locs: List[str]):
        d = os.path.join(meta_root, split)
        os.makedirs(d, exist_ok=True)
        for name, rows in (("image_ids.txt", ids),
                           ("class_labels.txt", labels),
                           ("image_sizes.txt", sizes),
                           ("localization.txt", locs)):
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(rows) + ("\n" if rows else ""))

    write("train", train_ids, train_labels, [], [])
    # eval splits index frames: every 2nd frame for val, the rest for test
    val_sel = list(range(0, len(eval_rows["ids"]), 2))
    tst_sel = list(range(1, len(eval_rows["ids"]), 2))
    # test-video-demo: video 0000 of each class from the test pool
    demo_sel = [i for i in tst_sel
                if eval_rows["ids"][i].split("/")[2] == "0000"]
    for split, sel in (("val", val_sel), ("test", tst_sel),
                       ("test-video-demo", demo_sel)):
        write(split,
              [eval_rows["ids"][i] for i in sel],
              [eval_rows["labels"][i] for i in sel],
              [eval_rows["sizes"][i] for i in sel],
              [eval_rows["locs"][i] for i in sel])

    with open(os.path.join(meta_root, "class_id.yaml"), "w") as f:
        f.write("{" + ", ".join(f"{c}: {i}" for i, c in enumerate(classes))
                + "}\n")
    # alias so `<parent>/<dataset-name>` resolves like a real install
    alias = os.path.join(root, "YouTube-Objects-v1.0")
    if not os.path.exists(alias):
        os.symlink(data_root, alias)
    out: Dict[str, object] = {"data_root": data_root,
                              "metadata_root": meta_root, "parent": root}
    if keep_frames:
        out["frames"] = kept
    return out


def _blur_1d(n: int, sigma: float) -> np.ndarray:
    """(n, n) row-normalized Gaussian smoothing matrix."""
    x = np.arange(n, dtype=np.float64)
    k = np.exp(-0.5 * ((x[:, None] - x[None, :]) / sigma) ** 2)
    return k / k.sum(1, keepdims=True)


def make_stand_in_cam_store(metadata_root: str, out_dir: str,
                            cam_size: int = 28, sigma: float = 1.5,
                            noise: float = 0.05, seed: int = 0) -> CamStore:
    """One (cam_size, cam_size) CAM per frame of the val and test splits
    (the synthetic set's splits hold every frame): the frame's GT boxes
    as a mask at CAM resolution, Gaussian-blurred (sigma in CAM cells),
    scaled to a peak of 1, plus N(0, noise) drawn from `seed`, clipped to
    [0, 1].  No thresholds file is written."""
    rng = np.random.default_rng(seed)
    store = CamStore(out_dir)
    blur = _blur_1d(cam_size, sigma)
    for split in ("val", "test"):
        md = load_split_metadata(metadata_root, split)
        for iid in md.image_ids:
            w, h = md.sizes[iid]
            mask = np.zeros((cam_size, cam_size))
            for x0, y0, x1, y1 in md.boxes.get(iid, []):
                r0 = int(y0 * cam_size / h)
                r1 = int(np.ceil((y1 + 1) * cam_size / h))
                c0 = int(x0 * cam_size / w)
                c1 = int(np.ceil((x1 + 1) * cam_size / w))
                mask[r0:r1, c0:c1] = 1.0
            cam = blur @ mask @ blur.T
            cam = cam / max(cam.max(), 1e-12)
            cam = cam + rng.normal(0.0, noise, cam.shape)
            store.save_cam(iid, np.clip(cam, 0.0, 1.0).astype(np.float32))
    return store
