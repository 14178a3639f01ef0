"""Box helpers of the evaluation protocol (port of ops/boxes.py
resize_bbox)."""
from __future__ import annotations

from typing import Tuple


def resize_bbox(box, image_size, resize_size) -> Tuple[int, int, int, int]:
    """Scale a box x0, y0, x1, y1 from image size (w, h) to (w', h');
    coordinates truncate to int after scaling, as the protocol's GT
    boxes do."""
    x0, y0, x1, y1 = (float(v) for v in box)
    w_ratio = resize_size[0] / float(image_size[0])
    h_ratio = resize_size[1] / float(image_size[1])
    return (int(x0 * w_ratio), int(y0 * h_ratio),
            int(x1 * w_ratio), int(y1 * h_ratio))
