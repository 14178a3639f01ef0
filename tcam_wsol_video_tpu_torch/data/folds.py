"""Metadata folds reader (port of data/folds.py).

Per split, the wsol-done-right text files: image_ids.txt (one relative
path per line; image_ids_proxy.txt for the proxy train subset),
class_labels.txt (`id,label`), image_sizes.txt (`id,w,h`) and
localization.txt (`id,x0,y0,x1,y1`, one line per box), plus class_id.yaml
at the folds root.  class_id.yaml is a flat `name: id` mapping, read here
without a YAML library, in block form (one `name: id` per line) or flow
form (`{a: 0, b: 1}`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tcam_wsol_video_tpu_torch.ops.boxes import resize_bbox


@dataclass
class SplitMetadata:
    split: str
    image_ids: List[str]
    labels: Dict[str, int]
    sizes: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    boxes: Dict[str, List[Tuple[float, float, float, float]]] = \
        field(default_factory=dict)
    mask_paths: Dict[str, List[str]] = field(default_factory=dict)

    def __len__(self):
        return len(self.image_ids)


def _read_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_split_metadata(metadata_root: str, split: str,
                        image_ids: Optional[List[str]] = None,
                        proxy: bool = False) -> SplitMetadata:
    """proxy=True reads image_ids_proxy.txt, the reduced train subset."""
    root = os.path.join(metadata_root, split)
    ids_file = "image_ids_proxy.txt" if proxy else "image_ids.txt"
    ids = image_ids or _read_lines(os.path.join(root, ids_file))

    labels: Dict[str, int] = {}
    for ln in _read_lines(os.path.join(root, "class_labels.txt")):
        iid, lab = ln.rsplit(",", 1)
        labels[iid] = int(lab)

    md = SplitMetadata(split=split, image_ids=ids, labels=labels)

    sizes_path = os.path.join(root, "image_sizes.txt")
    if os.path.isfile(sizes_path):
        for ln in _read_lines(sizes_path):
            parts = ln.split(",")
            iid, w, h = ",".join(parts[:-2]), parts[-2], parts[-1]
            md.sizes[iid] = (int(float(w)), int(float(h)))

    loc_path = os.path.join(root, "localization.txt")
    if os.path.isfile(loc_path):
        for ln in _read_lines(loc_path):
            parts = ln.split(",")
            if len(parts) >= 5 and not parts[-1].endswith((".png", ".jpg")):
                iid = ",".join(parts[:-4])
                box = tuple(float(v) for v in parts[-4:])
                md.boxes.setdefault(iid, []).append(box)  # type: ignore
            elif len(parts) == 2:  # OpenImages: id, mask path
                md.mask_paths.setdefault(parts[0], []).append(parts[1])
    return md


def _scalar(tok: str):
    """A YAML plain scalar of the mapping: int, else the unquoted string."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        return tok


def parse_flat_mapping(text: str) -> Dict[str, int]:
    """A flat YAML mapping of scalars, block or flow form."""
    body = "\n".join(ln.split(" #", 1)[0] for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    stripped = body.strip()
    if stripped.startswith("{"):
        if not stripped.endswith("}"):
            raise ValueError("unterminated flow mapping in class_id.yaml")
        items = [it for it in stripped[1:-1].split(",") if it.strip()]
    else:
        items = [ln for ln in body.splitlines() if ln.strip()]
    out: Dict[str, int] = {}
    for it in items:
        if ":" not in it:
            raise ValueError(f"not a `name: id` entry: {it!r}")
        k, v = it.rsplit(":", 1)
        out[_scalar(k)] = _scalar(v)
    return out


def load_class_ids(metadata_root: str) -> Dict[str, int]:
    with open(os.path.join(metadata_root, "class_id.yaml")) as f:
        return parse_flat_mapping(f.read())


def subsample_per_class(md: SplitMetadata, n_per_class: int,
                        rng: np.random.Generator) -> SplitMetadata:
    """Keep n_per_class randomly chosen ids per class (the
    num_val_sample_per_class mini-val); 0 is the identity."""
    if n_per_class == 0:
        return md
    ids = np.asarray(md.image_ids)
    labels = np.asarray([md.labels[i] for i in md.image_ids])
    keep: List[str] = []
    for lab in np.unique(labels):
        idx = np.where(labels == lab)[0]
        take = min(n_per_class, len(idx))
        keep += ids[rng.choice(idx, take, replace=False)].tolist()
    return SplitMetadata(
        split=md.split, image_ids=keep,
        labels={i: md.labels[i] for i in keep},
        sizes={i: md.sizes[i] for i in keep if i in md.sizes},
        boxes={i: md.boxes[i] for i in keep if i in md.boxes},
        mask_paths={i: md.mask_paths[i] for i in keep
                    if i in md.mask_paths})


def resized_gt_boxes(md: SplitMetadata, image_id: str,
                     crop_size: int) -> np.ndarray:
    """GT boxes scaled from the original image size to crop_size."""
    w, h = md.sizes[image_id]
    out = [resize_bbox(b, (w, h), (crop_size, crop_size))
           for b in md.boxes.get(image_id, [])]
    return np.asarray(out, np.float32).reshape(-1, 4)
