"""Metadata folds reader (port of data/folds.py).

Per split, the wsol-done-right text files: image_ids.txt (one relative
path per line; image_ids_proxy.txt for the proxy train subset),
class_labels.txt (`id,label`), image_sizes.txt (`id,w,h`) and
localization.txt (`id,x0,y0,x1,y1`, one line per box), plus class_id.yaml
at the folds root.  class_id.yaml is a flat `name: id` mapping, read here
without a YAML library (`parse_flat_mapping`, which also reads the flat
recipe yamls of config_yaml/), in block form (one `name: id` per line) or
flow form (`{a: 0, b: 1}`).
"""
from __future__ import annotations

import os
import re
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


# YAML 1.1 plain-scalar resolution as PyYAML's safe_load applies it (its
# resolver's patterns): `1e-5` has no dot and stays a string, `2.0e-9`
# is a float, yes/no/on/off are booleans and `~` is null
_YAML_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|"
                        r"False|FALSE|on|On|ON|off|Off|OFF)$")
_YAML_TRUE = {"yes", "true", "on"}
_YAML_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_YAML_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# plain scalars that safe_load resolves to types this reader does not
# build (timestamps, merge keys, the value key)
_YAML_OTHER = re.compile(r"^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")


def _sexagesimal(text: str) -> float:
    value = 0.0
    for part in text.split(":"):
        value = value * 60 + float(part)
    return value


def _yaml_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if ":" in t:
        return sign * int(_sexagesimal(t))
    if t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _yaml_float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    t = t.lstrip("+-")
    if t == ".inf":
        return sign * float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return sign * _sexagesimal(t)
    return sign * float(t)


def parse_scalar(tok: str):
    """One YAML scalar as safe_load types it: a quoted string, else null,
    bool, int, float or the plain string.  Anything nested (a flow
    sequence or mapping, an anchor, a tag, a block scalar) raises."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        if "\\" in tok:
            raise ValueError(f"escapes in a quoted scalar: {tok!r}")
        return tok[1:-1]
    if (tok[:1] in ("[", "{", "&", "*", "!", "|", ">", "'", '"', "@", "`")
            or tok in ("-", "?") or tok.startswith(("- ", "? "))):
        raise ValueError(f"not a flat scalar: {tok!r}")
    if _YAML_NULL.match(tok):
        return None
    if _YAML_BOOL.match(tok):
        return tok.lower() in _YAML_TRUE
    if _YAML_INT.match(tok):
        return _yaml_int(tok)
    if _YAML_FLOAT.match(tok):
        return _yaml_float(tok)
    if _YAML_OTHER.match(tok):
        raise ValueError(f"a YAML scalar this reader does not type: {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    """The line without its comment: `#` at its start or after blanks,
    outside quotes."""
    quote = ""
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = ""
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_flat_mapping(text: str) -> Dict:
    """A flat YAML mapping of scalars, block form (one `key: value` a
    line, comments allowed) or flow form (`{a: 0, b: 1}`), with keys and
    values typed as PyYAML's safe_load types them.  An indented line, a
    sequence or any other nesting raises ValueError."""
    lines = [_strip_comment(ln).rstrip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln.strip() and ln.strip() != "---"]
    stripped = "\n".join(lines).strip()
    if stripped.startswith("{"):
        if not stripped.endswith("}"):
            raise ValueError("unterminated flow mapping")
        items = [it for it in stripped[1:-1].split(",") if it.strip()]
    else:
        items = lines
        for ln in items:
            if ln[:1] in " \t":
                raise ValueError(f"a nested or continued entry: {ln!r}")
    out: Dict = {}
    for it in items:
        it = it.strip()
        if ": " in it:
            k, _, v = it.partition(": ")
        elif it.endswith(":"):
            k, v = it[:-1], ""
        else:
            raise ValueError(f"not a `key: value` entry: {it!r}")
        key = parse_scalar(k)
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        out[key] = parse_scalar(v)
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


def build_size_priors(md: SplitMetadata, crop_size: int,
                      num_classes: int) -> Dict[str, np.ndarray]:
    """Per-class box-size priors from a split's GT boxes resized to
    crop_size (JAX data/folds.build_size_priors): for each class the
    min and max of each box's height and width over crop_size and of
    their product, over every GT box.  Returns {'min_h', 'max_h',
    'min_w', 'max_w', 'min_s', 'max_s'} -> (num_classes,) float32; a
    class without boxes keeps min 0 and max 1 (C_BOX's pre-forward then
    treats it as under size_constant)."""
    mins = {k: np.full((num_classes,), np.inf, np.float32)
            for k in ("min_h", "min_w", "min_s")}
    maxs = {k: np.zeros((num_classes,), np.float32)
            for k in ("max_h", "max_w", "max_s")}
    for iid in md.image_ids:
        lab = md.labels[iid]
        for x0, y0, x1, y1 in resized_gt_boxes(md, iid, crop_size):
            w = (x1 - x0) / float(crop_size)
            h = (y1 - y0) / float(crop_size)
            s = h * w
            for k, v in (("min_h", h), ("min_w", w), ("min_s", s)):
                mins[k][lab] = min(mins[k][lab], v)
            for k, v in (("max_h", h), ("max_w", w), ("max_s", s)):
                maxs[k][lab] = max(maxs[k][lab], v)
    for k in mins:
        mins[k] = np.where(np.isfinite(mins[k]), mins[k], 0.0
                           ).astype(np.float32)
    for k in maxs:
        maxs[k] = np.where(maxs[k] > 0, maxs[k], 1.0).astype(np.float32)
    return {**mins, **maxs}
