"""Offline dataset builders (port of data/builders.py): a raw
YouTube-Objects release, or YouTube-BoundingBoxes' detection CSVs, ->
wsol-done-right metadata folds.

A raw YTO release is `<class>/data/<video>/shots/<shot>/frame*.jpg`, with
per-frame `*_sticks.mat` box annotations holding a 'coor' cell array of
[x0, y0, x1, y1] boxes (read with scipy.io).  Then
- test split = every annotated frame (ids, labels, sizes, boxes);
- train split = all shots of the remaining videos (weak labels only:
  localization.txt empty);
- val split = annotated frames of K held-out videos per class (K = 5 for
  v1.0, 3 for v2.2);
- test-video-demo = all frames of the test videos (for demo videos).
Negative coordinates are clipped to 0, flipped or overshooting boxes
repaired, and unrecoverable ones dropped.  An image's size is read from
its JPEG frame header (jpeg_size), not decoded.  The files written are
byte for byte the JAX builders'.
"""
from __future__ import annotations

import fnmatch
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HELD_OUT_VAL_VIDEOS = {"v1.0": 5, "v2.2": 3}


def clip_negative(v: np.ndarray) -> np.ndarray:
    return np.abs(v * (v > 0))


def repair_box(bbox: List[float], img_path: str,
               img_size: Tuple[int, int]) -> Optional[List[float]]:
    """Outlier repair (the upstream builders' fix_bbox): swap flipped
    extents, clamp an overshooting x1 / y1; None for an unrecoverable
    box."""
    x0, y0, x1, y1 = bbox
    w, h = img_size
    if x1 < x0:
        x0, x1 = x1, x0
    if y1 < y0:
        y0, y1 = y1, y0
    x1 = min(x1, w - 1)
    y1 = min(y1, h - 1)
    if not (0 < x1 - x0 < w and 0 < y1 - y0 < h):
        return None
    return [x0, y0, x1, y1]


# the start-of-frame markers (baseline, extended, progressive, lossless
# and their arithmetic-coded forms); C4, C8 and CC are not frames
_SOF_MARKERS = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG from its start-of-frame header."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG file")
        while True:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"{path}: no frame header")
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":
                marker = f.read(1)
            m = marker[0] if marker else 0
            if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
                continue            # markers without a length
            (length,) = struct.unpack(">H", f.read(2))
            if m in _SOF_MARKERS:
                _, h, w = struct.unpack(">BHH", f.read(5))
                return w, h
            f.seek(length - 2, os.SEEK_CUR)


def load_sticks_boxes(matfile: str) -> List[List[float]]:
    """Read the 'coor' cell array of one *_sticks.mat annotation."""
    from scipy import io as sio
    img_path = matfile.replace("_sticks.mat", "")
    w, h = jpeg_size(img_path)
    mat = sio.loadmat(matfile)["coor"]
    out = []
    for el in np.asarray(mat).reshape(mat.size):
        el = clip_negative(np.asarray(el, dtype=np.float64))
        box = repair_box(el.squeeze().tolist(), img_path, (w, h))
        if box is not None:
            out.append(box)
    return out


@dataclass
class RawIndex:
    """Indexed raw release: class -> video -> shot -> frames (+ annots)."""
    classes: List[str] = field(default_factory=list)
    shots: Dict[str, List[str]] = field(default_factory=dict)
    # frame id -> list of boxes (annotated frames only)
    annots: Dict[str, List[List[float]]] = field(default_factory=dict)
    sizes: Dict[str, Tuple[int, int]] = field(default_factory=dict)


def index_raw_release(root: str) -> RawIndex:
    idx = RawIndex()
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d, "data")))
    idx.classes = classes
    for cname in classes:
        data_dir = os.path.join(root, cname, "data")
        for vid in sorted(os.listdir(data_dir)):
            shots_dir = os.path.join(data_dir, vid, "shots")
            if not os.path.isdir(shots_dir):
                continue
            for shot in sorted(os.listdir(shots_dir)):
                shot_dir = os.path.join(shots_dir, shot)
                if not os.path.isdir(shot_dir):
                    continue
                shot_id = f"{cname}/data/{vid}/shots/{shot}"
                frames = sorted(f for f in os.listdir(shot_dir)
                                if f.endswith(".jpg"))
                if not frames:
                    continue  # empty shots are skipped
                idx.shots[shot_id] = frames
                for f in os.listdir(shot_dir):
                    if fnmatch.fnmatch(f, "*_sticks.mat"):
                        fid = f"{shot_id}/{f.replace('_sticks.mat', '')}"
                        mat_path = os.path.join(shot_dir, f)
                        boxes = load_sticks_boxes(mat_path)
                        if boxes:
                            idx.annots[fid] = boxes
                            idx.sizes[fid] = jpeg_size(
                                os.path.join(root, fid))
    return idx


def _video_of(frame_or_shot_id: str) -> str:
    # class/data/<video>/shots/...
    parts = frame_or_shot_id.split("/")
    return "/".join(parts[:3])


def split_videos(idx: RawIndex, k_val: int, seed: int = 0
                 ) -> Tuple[Dict[str, List[str]], Dict[str, List[str]],
                            Dict[str, List[str]]]:
    """Per class: videos with annotations feed test; from the rest, k_val
    random videos (with annotations if possible) are held out for val;
    remaining videos train (annotated videos held out of the train
    pool, as upstream)."""
    rng = np.random.default_rng(seed)
    annotated_videos: Dict[str, set] = {}
    for fid in idx.annots:
        cname = fid.split("/")[0]
        annotated_videos.setdefault(cname, set()).add(_video_of(fid))

    test_vids: Dict[str, List[str]] = {}
    val_vids: Dict[str, List[str]] = {}
    train_vids: Dict[str, List[str]] = {}
    all_videos: Dict[str, set] = {}
    for shot_id in idx.shots:
        cname = shot_id.split("/")[0]
        all_videos.setdefault(cname, set()).add(_video_of(shot_id))

    for cname in idx.classes:
        ann = sorted(annotated_videos.get(cname, set()))
        if len(ann) > k_val:
            sel = rng.permutation(len(ann))
            val = [ann[i] for i in sel[:k_val]]
        else:
            val = ann[:max(0, len(ann) - 1)]
        test = [v for v in ann if v not in val]
        train = sorted(all_videos.get(cname, set()) - set(val))
        test_vids[cname] = test
        val_vids[cname] = val
        train_vids[cname] = train
    return train_vids, val_vids, test_vids


def _write_split(out_dir: str, ids: Sequence[str],
                 labels: Dict[str, int],
                 sizes: Optional[Dict[str, Tuple[int, int]]],
                 boxes: Optional[Dict[str, List[List[float]]]]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "image_ids.txt"), "w") as f:
        f.writelines(i + "\n" for i in ids)
    with open(os.path.join(out_dir, "class_labels.txt"), "w") as f:
        f.writelines(f"{i},{labels[i]}\n" for i in ids)
    with open(os.path.join(out_dir, "image_sizes.txt"), "w") as f:
        if sizes:
            f.writelines(f"{i},{sizes[i][0]},{sizes[i][1]}\n" for i in ids)
    with open(os.path.join(out_dir, "localization.txt"), "w") as f:
        if boxes:
            for i in ids:
                for b in boxes[i]:
                    f.write(f"{i},{b[0]},{b[1]},{b[2]},{b[3]}\n")


def build_metadata(raw_root: str, out_root: str, version: str = "v1.0",
                   seed: int = 0) -> Dict[str, int]:
    """Build train/val/test (+test-video-demo) folds from a raw release.
    Returns the class -> id map (also written to class_id.yaml)."""
    if version not in HELD_OUT_VAL_VIDEOS:
        raise ValueError(f"version must be one of "
                         f"{sorted(HELD_OUT_VAL_VIDEOS)}, got {version!r}")
    idx = index_raw_release(raw_root)
    class_id = {c: i for i, c in enumerate(idx.classes)}
    train_vids, val_vids, test_vids = split_videos(
        idx, HELD_OUT_VAL_VIDEOS[version], seed=seed)

    # train: shot ids of train videos, weak labels only
    train_ids = [s for s in idx.shots
                 if _video_of(s) in set(train_vids[s.split("/")[0]])]
    train_labels = {s: class_id[s.split("/")[0]] for s in train_ids}
    _write_split(os.path.join(out_root, "train"), train_ids, train_labels,
                 None, None)

    # val / test: annotated frames of held-out / annotated videos
    for split, vids in (("val", val_vids), ("test", test_vids)):
        ids = [fid for fid in idx.annots
               if _video_of(fid) in set(vids[fid.split("/")[0]])]
        labels = {i: class_id[i.split("/")[0]] for i in ids}
        _write_split(os.path.join(out_root, split), ids, labels,
                     idx.sizes, idx.annots)

    # demo split: every frame of the test videos
    demo_ids = []
    demo_labels = {}
    demo_sizes = {}
    demo_boxes: Dict[str, List[List[float]]] = {}
    for shot_id, frames in idx.shots.items():
        cname = shot_id.split("/")[0]
        if _video_of(shot_id) not in set(test_vids[cname]):
            continue
        for fr in frames:
            fid = f"{shot_id}/{fr}"
            demo_ids.append(fid)
            demo_labels[fid] = class_id[cname]
            demo_sizes[fid] = idx.sizes.get(fid, (0, 0))
            demo_boxes[fid] = idx.annots.get(fid, [])
    _write_split(os.path.join(out_root, "test-video-demo"), demo_ids,
                 demo_labels, demo_sizes, demo_boxes)

    with open(os.path.join(out_root, "class_id.yaml"), "w") as f:
        f.write("{" + ", ".join(f"{c}: {i}" for c, i in class_id.items())
                + "}\n")
    return class_id


# ----------------------------------------------------------------- YT-BB
# YouTube-BoundingBoxes: the official detection CSV converted into the
# same folds the video loader reads.
#
# CSV format (official yt_bb_detection_{train,validation}.csv):
#   youtube_id, timestamp_ms, class_id, class_name, object_id,
#   object_presence ('present'/'absent'), xmin, xmax, ymin, ymax
# with corner coordinates normalized to [0, 1] (-1 when absent).
#
# Frame-file contract: frames extracted at the annotated timestamps,
# stored as <frames_root>/<class>/<youtube_id>_<object>/0/<timestamp>.jpg
# ((youtube_id, object) is the "video"; YT-BB annotates one contiguous
# ~1 fps segment per object, which becomes its single shot "0").

@dataclass
class YtbbRow:
    youtube_id: str
    timestamp_ms: int
    class_name: str
    object_id: str
    present: bool
    box: Tuple[float, float, float, float]  # normalized x0, x1, y0, y1


def parse_ytbb_detection_csv(csv_path: str) -> List[YtbbRow]:
    rows: List[YtbbRow] = []
    with open(csv_path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            p = line.split(",")
            # only a header line is skipped; any other malformed row
            # raises with its location
            if p[0].strip().lower() in ("youtube_id", "video_id"):
                continue
            try:
                if len(p) < 10:
                    raise ValueError(f"expected >= 10 fields, got {len(p)}")
                rows.append(YtbbRow(
                    youtube_id=p[0], timestamp_ms=int(p[1]),
                    class_name=p[3], object_id=p[4],
                    present=p[5].strip().strip('"') == "present",
                    box=(float(p[6]), float(p[7]),
                         float(p[8]), float(p[9]))))
            except ValueError as e:
                raise ValueError(
                    f"malformed YT-BB row at {csv_path}:{lineno}: "
                    f"{line!r}") from e
    return rows


def _ytbb_frame_id(r: YtbbRow) -> str:
    return (f"{r.class_name}/{r.youtube_id}_{r.object_id}/0/"
            f"{r.timestamp_ms}.jpg")


def _ytbb_index(rows: List[YtbbRow], frames_root: str):
    """Group rows by (class-pure) video; drop videos whose youtube_id
    carries several classes (upstream's localization criterion,
    check_object_loc) and frames missing on disk (box denormalization
    needs the real size)."""
    by_yid: Dict[str, set] = {}
    for r in rows:
        by_yid.setdefault(r.youtube_id, set()).add(r.class_name)
    pure = {y for y, cs in by_yid.items() if len(cs) == 1}

    ids: List[str] = []
    labels_cls: Dict[str, str] = {}
    sizes: Dict[str, Tuple[int, int]] = {}
    boxes: Dict[str, List[List[float]]] = {}
    videos: Dict[str, set] = {}
    for r in rows:
        if r.youtube_id not in pure or not r.present:
            continue
        fid = _ytbb_frame_id(r)
        path = os.path.join(frames_root, fid)
        if not os.path.isfile(path):
            continue
        if fid not in sizes:
            sizes[fid] = jpeg_size(path)
            ids.append(fid)
            labels_cls[fid] = r.class_name
            boxes[fid] = []
            videos.setdefault(r.class_name, set()).add(
                f"{r.youtube_id}_{r.object_id}")
        w, h = sizes[fid]
        x0, x1, y0, y1 = r.box
        # denormalize to the +1-exclusive pixel convention used by the
        # YTO builders (x1/y1 exclusive corner)
        boxes[fid].append([max(x0 * w, 0.0), max(y0 * h, 0.0),
                           min(x1 * w + 1, float(w)),
                           min(y1 * h + 1, float(h))])
    return ids, labels_cls, sizes, boxes, videos


def build_ytbb_metadata(csv_train: str, csv_validation: str,
                        frames_root: str, out_root: str, k_val: int = 3,
                        seed: int = 0) -> Dict[str, int]:
    """YT-BB detection CSVs -> wsol-done-right folds.

    The official validation CSV becomes the test split; k_val videos per
    class held out of the train CSV become val (annotated frames);
    remaining train videos keep weak labels only — mirroring the YTO
    held-out-val convention (HELD_OUT_VAL_VIDEOS)."""
    rng = np.random.default_rng(seed)
    tr_ids, tr_cls, tr_sizes, tr_boxes, tr_videos = _ytbb_index(
        parse_ytbb_detection_csv(csv_train), frames_root)
    te_ids, te_cls, te_sizes, te_boxes, _ = _ytbb_index(
        parse_ytbb_detection_csv(csv_validation), frames_root)

    classes = sorted(set(tr_cls.values()) | set(te_cls.values()))
    class_id = {c: i for i, c in enumerate(classes)}

    val_videos: set = set()
    for cname in classes:
        vids = sorted(tr_videos.get(cname, set()))
        sel = rng.permutation(len(vids))[:min(k_val, max(len(vids) - 1, 0))]
        val_videos.update(vids[i] for i in sel)

    def vid_of(fid: str) -> str:
        return fid.split("/")[1]

    val_ids = [i for i in tr_ids if vid_of(i) in val_videos]
    train_ids = [i for i in tr_ids if vid_of(i) not in val_videos]

    _write_split(os.path.join(out_root, "train"), train_ids,
                 {i: class_id[tr_cls[i]] for i in train_ids}, None, None)
    _write_split(os.path.join(out_root, "val"), val_ids,
                 {i: class_id[tr_cls[i]] for i in val_ids},
                 tr_sizes, tr_boxes)
    _write_split(os.path.join(out_root, "test"), te_ids,
                 {i: class_id[te_cls[i]] for i in te_ids},
                 te_sizes, te_boxes)

    with open(os.path.join(out_root, "class_id.yaml"), "w") as f:
        f.write("{" + ", ".join(f"{c}: {i}" for c, i in class_id.items())
                + "}\n")
    return class_id
