"""The synthetic YouTube-Objects-like set of a cell, drawn from --seed.

The drawing is the JAX package's data/synthetic.py, kept here: classes x
videos x shots x frames; each frame is uniform noise in [0, 60) with a
square of the class's colour, 30% of the frame's width and height, that
drifts 2 px right each frame of the shot.  The noise is drawn on the
device from a torch.Generator, 64 frames a call; the square's start per
shot from a NumPy stream; both from the seed.  The frames are written as
baseline JPEGs (quality 95) by the program's codec (nvJPEG on the card,
libjpeg on the CPU: the set's file format, which both the program and its
users read), with the wsol-done-right folds: train ids are shots, val the
even frames, test the odd ones.

The stand-in CAM store (the stage-1 CAMs that stage 2 distils) holds a
28 x 28 CAM a frame: the GT box as a mask, blurred (sigma 1.5 cells),
scaled to a peak of 1, plus N(0, 0.05) noise, clipped to [0, 1] (the
program's data/synthetic.make_stand_in_cam_store, kept here).

The source frames and CAMs stay in host memory for the reference."""
from __future__ import annotations

import colorsys
import os
import shutil
from typing import Dict

import numpy as np
import torch

from benchmark.reference.keychain import seed_of

DATASET = "YouTube-Objects-v1.0"
JPEG_QUALITY = 95
CAM_SIZE = 28
DRAW_CHUNK = 64


def class_colors(n: int):
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40),
              (220, 40, 220)]
    for i in range(len(colors), n):
        r, g, b = colorsys.hsv_to_rgb((i + 0.5) / n, 0.85, 0.8)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return colors


def _blur(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n, dtype=np.float64)
    k = np.exp(-0.5 * ((x[:, None] - x[None, :]) / sigma) ** 2)
    return k / k.sum(1, keepdims=True)


def stand_in_cams(boxes: np.ndarray, hw, rng: np.random.Generator,
                  sigma: float = 1.5, noise: float = 0.05) -> np.ndarray:
    """(N, 4) inclusive boxes x0, y0, x1, y1 -> (N, 28, 28) float32."""
    h, w = hw
    n = len(boxes)
    masks = np.zeros((n, CAM_SIZE, CAM_SIZE))
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        masks[i, int(y0 * CAM_SIZE / h):int(np.ceil((y1 + 1) * CAM_SIZE / h)),
              int(x0 * CAM_SIZE / w):int(np.ceil((x1 + 1) * CAM_SIZE / w))] = 1
    blur = _blur(CAM_SIZE, sigma)
    cams = blur @ masks @ blur.T
    cams = cams / np.maximum(cams.max((1, 2), keepdims=True), 1e-12)
    cams = cams + rng.normal(0.0, noise, cams.shape)
    return np.clip(cams, 0.0, 1.0).astype(np.float32)


def make_set(root: str, spec: dict, seed: int, device: torch.device,
             encode) -> Dict[str, object]:
    """Writes the set under root (emptied first).  spec: n_classes,
    n_videos_per_class, n_shots_per_video, n_frames_per_shot, frame_hw.
    encode(img (h, w, 3) uint8) -> JPEG bytes.  Returns the paths, the
    shots, frames and labels, and the source frames and CAMs by id."""
    shutil.rmtree(root, ignore_errors=True)
    data_root = os.path.join(root, DATASET)
    meta_root = os.path.join(root, "folds")
    h, w = spec["frame_hw"]
    nf = spec["n_frames_per_shot"]
    n_cls = spec["n_classes"]
    colors = class_colors(n_cls)
    rng = np.random.default_rng(seed_of(seed, "bench", "boxes"))
    bw, bh = int(w * 0.3), int(h * 0.3)

    shots, labels, frames_of = [], {}, {}
    ids, boxes, cls = [], [], []
    for ci in range(n_cls):
        for vi in range(spec["n_videos_per_class"]):
            for si in range(spec["n_shots_per_video"]):
                shot = f"class{ci}/data/{vi:04d}/shots/{si:03d}"
                x0 = int(rng.integers(0, w - bw - nf * 2))
                y0 = int(rng.integers(0, h - bh - 2))
                frames_of[shot] = []
                for fi in range(nf):
                    fid = f"{shot}/frame{fi:04d}.jpg"
                    frames_of[shot].append(fid)
                    ids.append(fid)
                    boxes.append((x0 + 2 * fi, y0, x0 + 2 * fi + bw,
                                  y0 + bh))
                    cls.append(ci)
                shots.append(shot)
                labels[shot] = ci
                os.makedirs(os.path.join(data_root, shot), exist_ok=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "bench", "frames"))
    col = torch.tensor(colors, dtype=torch.uint8, device=device)
    frames = np.empty((len(ids), h, w, 3), np.uint8)
    for c0 in range(0, len(ids), DRAW_CHUNK):
        n = min(DRAW_CHUNK, len(ids) - c0)
        img = (torch.rand((n, h, w, 3), generator=gen, device=device)
               * 60).to(torch.uint8)
        for j in range(n):
            x0, y0, x1, y1 = boxes[c0 + j]
            img[j, y0:y1 + 1, x0:x1 + 1] = col[cls[c0 + j] % len(colors)]
        frames[c0:c0 + n] = img.cpu().numpy()
    for i, fid in enumerate(ids):
        with open(os.path.join(data_root, fid), "wb") as f:
            f.write(encode(frames[i]))

    cams = stand_in_cams(np.asarray(boxes), (h, w), rng)
    store = os.path.join(root, "cams")
    for i, fid in enumerate(ids):
        path = os.path.join(store, fid + ".npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, cams[i])

    def write(split, split_ids, lab, sizes, locs):
        d = os.path.join(meta_root, split)
        os.makedirs(d, exist_ok=True)
        for name, rows in (("image_ids.txt", split_ids),
                           ("class_labels.txt", lab),
                           ("image_sizes.txt", sizes),
                           ("localization.txt", locs)):
            with open(os.path.join(d, name), "w") as f:
                f.write("".join(r + "\n" for r in rows))

    write("train", shots, [f"{s},{labels[s]}" for s in shots], [], [])
    for split, sel in (("val", range(0, len(ids), 2)),
                       ("test", range(1, len(ids), 2))):
        write(split, [ids[i] for i in sel],
              [f"{ids[i]},{cls[i]}" for i in sel],
              [f"{ids[i]},{w},{h}" for i in sel],
              [f"{ids[i]},{','.join(str(v) for v in boxes[i])}"
               for i in sel])
    with open(os.path.join(meta_root, "class_id.yaml"), "w") as f:
        f.write("{" + ", ".join(f"class{i}: {i}" for i in range(n_cls))
                + "}\n")
    return {"root": root, "metadata_root": meta_root, "cam_store": store,
            "shots": shots, "frames_of": frames_of, "labels": labels,
            "frames": {fid: frames[i] for i, fid in enumerate(ids)},
            "cams": {fid: cams[i] for i, fid in enumerate(ids)},
            "n_frames": len(ids)}
