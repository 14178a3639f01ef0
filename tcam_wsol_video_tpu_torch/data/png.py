"""PNG over the standard library's zlib: a reader for the GT masks and a
writer for the figures, with Pillow's pixel rules where a mask is read.

`read_png` decodes non-interlaced PNGs of every colour type at 8 bits per
sample, grayscale and palette at 1, 2 and 4 bits too, to an array as
Pillow's Image.open gives it (mode L, RGB, P with its palette, LA or RGBA;
a 1-bit grayscale image as mode 1, 0 / 255).  `to_luma` is Pillow's
convert("L"): ITU-R 601-2 luma with its integer rounding, a palette image
through its palette's luma, alpha dropped.  `resize_nearest` is Pillow's
Image.resize(..., NEAREST): the source column of output column x is the
truncation of a running sum that starts at scale / 2 and adds scale each
column, rows likewise.  16-bit samples and interlaced files raise.

`write_png` writes an 8-bit grayscale or RGB image (filter 0 on every row).
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth_row(cur: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    out = cur.tolist()
    up_row = prior.tolist()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        up = up_row[i]
        ul = up_row[i - bpp] if i >= bpp else 0
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        pred = left if pa <= pb and pa <= pc else up if pb <= pc else ul
        out[i] = (out[i] + pred) & 255
    cur[:] = out


def _unfilter(raw: bytes, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < rows * (row_bytes + 1):
        raise ValueError("truncated PNG image data")
    buf = buf[:rows * (row_bytes + 1)].reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(rows):
        ftype = int(buf[y, 0])
        cur = buf[y, 1:].copy()
        if ftype == 1:      # Sub: a running sum per sample position
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(cur[k::bpp], dtype=np.uint64
                                        ).astype(np.uint8)
        elif ftype == 2:    # Up
            cur = (cur.astype(np.uint16) + prior).astype(np.uint8)
        elif ftype == 3:    # Average
            vals, up = cur.tolist(), prior.tolist()
            for i in range(row_bytes):
                left = vals[i - bpp] if i >= bpp else 0
                vals[i] = (vals[i] + ((left + up[i]) >> 1)) & 255
            cur[:] = vals
        elif ftype == 4:    # Paeth
            _paeth_row(cur, prior, bpp)
        elif ftype != 0:
            raise ValueError(f"unknown PNG filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(pixels, Pillow's mode, palette (256, 3) uint8 or None): pixels
    (H, W) for L / P / 1, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if ctype not in _CHANNELS or depth == 16 or (
            depth < 8 and ctype not in (0, 3)):
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits is "
                         "not read")
    ch = _CHANNELS[ctype]
    row_bytes = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, row_bytes, bpp)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        vals = bits.reshape(h, w, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (vals * weights).sum(-1).astype(np.uint8)
        if ctype == 0:
            if depth == 1:
                return px * np.uint8(255), "1", None
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)
                  ).astype(np.uint8)
            return px, "L", None
        return px, "P", _full_palette(palette)
    px = rows.reshape(h, w, ch) if ch > 1 else rows.reshape(h, w)
    mode = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ctype]
    return px, mode, _full_palette(palette) if ctype == 3 else None


def _full_palette(palette: Optional[np.ndarray]) -> np.ndarray:
    if palette is None:
        raise ValueError("a palette PNG without PLTE")
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette[:256]
    return full


def _rgb_luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def to_luma(px: np.ndarray, mode: str,
            palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Pillow's convert("L") of a read_png result."""
    if mode in ("L", "1"):
        return px
    if mode == "LA":
        return px[..., 0]
    if mode in ("RGB", "RGBA"):
        return _rgb_luma(px[..., :3])
    if mode == "P":
        return _rgb_luma(palette)[px]
    raise ValueError(f"mode {mode!r}")


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    idx = np.empty(n_out, np.int64)
    pos = scale * 0.5
    for i in range(n_out):
        idx[i] = int(pos)
        pos += scale
    return np.minimum(idx, n_in - 1)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's resize((w, h), NEAREST) of an (H, W[, C]) array."""
    w, h = size
    ys = _nearest_index(img.shape[0], h)
    xs = _nearest_index(img.shape[1], w)
    return img[ys][:, xs]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """An (H, W) grayscale or (H, W, 3) RGB uint8 image as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, ch = 2, 3
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, w * ch + 1), np.uint8)
    rows[:, 1:] = img.reshape(h, w * ch)
    body = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(body)
