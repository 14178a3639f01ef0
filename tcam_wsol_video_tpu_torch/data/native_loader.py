"""ctypes binding of native/fastloader.cpp and csrc/jpeg_write.cpp, the
host image route (data/image_route.py): libjpeg decode, half-pixel
bilinear resize, crop, flip and ImageNet normalization of a batch in one
OpenMP call (port of data/native_loader.py, signatures of its
load_batch); the decode to uint8 frames at resize resolution
(`decode_resize_u8`) and `DecodedFrameCache`, an LRU of those frames that
crops them with fastloader's crop_batch_u8; whole frames decoded at their
own size (from the JPEG header, `jpeg_hw`) and resized with Pillow's
bilinear arithmetic (the CAM dump's pixels); and libjpeg's encoder.  The
route's functions return tensors on the CPU, zero-copy views of the
numpy arrays the C code fills.

The libraries are built from the checkout's sources with the JAX
binding's g++ flags (core/nativebuild.py), so both packages decode the
same bits.  They need libjpeg; where that is missing the build raises.
The card's route is data/nvjpeg_loader.py.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core import nativebuild
from tcam_wsol_video_tpu_torch.data.transforms import pil_bilinear_resize

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_ubyte)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = nativebuild.load("fastloader")
    lib.load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _IP, _IP, _UP, _FP, _FP]
    lib.load_batch.restype = ctypes.c_int
    lib.decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _UP]
    lib.decode_resize_batch.restype = ctypes.c_int
    lib.crop_batch_u8.argtypes = [
        ctypes.POINTER(_UP), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _IP, _IP, _UP, _FP, _FP]
    lib.crop_batch_u8.restype = None
    return lib


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def load_batch(paths: List[str], resize: int, crop: int,
               xs: Optional[np.ndarray] = None,
               ys: Optional[np.ndarray] = None,
               flips: Optional[np.ndarray] = None, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode, resize to (resize, resize), crop at (ys, xs), flip and
    normalize a batch.  Returns (normalized (N, crop, crop, 3), raw
    (N, crop, crop, 3) in [0, 255]), float32."""
    n = len(paths)
    xs = np.ascontiguousarray(np.zeros(n) if xs is None else xs, np.int32)
    ys = np.ascontiguousarray(np.zeros(n) if ys is None else ys, np.int32)
    flips = np.ascontiguousarray(np.zeros(n) if flips is None else flips,
                                 np.uint8)
    out_norm = np.empty((n, crop, crop, 3), np.float32)
    out_raw = np.empty((n, crop, crop, 3), np.float32)
    rc = _lib().load_batch(
        _paths(paths), n, resize, resize, crop, xs.ctypes.data_as(_IP),
        ys.ctypes.data_as(_IP), flips.ctypes.data_as(_UP),
        out_norm.ctypes.data_as(_FP), out_raw.ctypes.data_as(_FP))
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return torch.from_numpy(out_norm), torch.from_numpy(out_raw)


def decode_u8(paths: List[str], height: int, width: int) -> np.ndarray:
    """Decode and resize to (N, height, width, 3) uint8 (rounded); at the
    frames' own size this is the plain decode."""
    n = len(paths)
    buf = np.empty((n, height, width, 3), np.uint8)
    rc = _lib().decode_resize_batch(_paths(paths), n, height, width,
                                    buf.ctypes.data_as(_UP))
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return buf


def decode_resize_u8(paths: List[str], resize: int, device="cpu"
                     ) -> torch.Tensor:
    """Decode and resize to (N, resize, resize, 3) uint8, each value the
    float resize rounded half up: the frames of the decoded-frame cache
    and of the card-resident train feed's pool."""
    return torch.from_numpy(decode_u8(paths, resize, resize))


def load_resized_u8(paths: List[str], size: Tuple[int, int], device="cpu"
                    ) -> torch.Tensor:
    """Decode each file at its own size and resize the whole frame to
    `size` as Pillow's BILINEAR does: (N, h, w, 3) uint8."""
    return torch.cat([pil_bilinear_resize(
        torch.from_numpy(decode_u8([p], *jpeg_hw(p))), size) for p in paths])


def frame_cache(budget_mb: int, device="cpu") -> "DecodedFrameCache":
    """The decoded-frame cache of the host route."""
    return DecodedFrameCache(budget_mb)


class DecodedFrameCache:
    """An LRU of decoded frames at resize resolution, uint8, across epochs
    (port of data/native_loader.py DecodedFrameCache): a batch decodes
    only the frames it misses, then crops, flips and normalizes all of
    them from the cache.  A frame that appears twice in a batch is decoded
    once and its bytes counted once; `hits` and `misses` count the frames
    served (a duplicate of a missing frame is a miss too); eviction never
    goes below the batch in flight.  Rounding the resize to uint8 changes
    a float32 run's pixels by at most half a level.  The frames are numpy
    arrays cropped by fastloader's crop_batch_u8 here;
    nvjpeg_loader.DeviceFrameCache keeps them on the card."""

    def __init__(self, budget_mb: int = 512):
        self.budget = int(budget_mb) * (1 << 20)
        self.frames: OrderedDict = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0

    def _decode(self, paths: List[str], resize: int) -> list:
        return [f.copy() for f in decode_u8(paths, resize, resize)]

    def _crop(self, frames: list, resize: int, crop: int, xs, ys, flips):
        n = len(frames)
        srcs = (_UP * n)(*[f.ctypes.data_as(_UP) for f in frames])
        xs = np.ascontiguousarray(xs, np.int32)
        ys = np.ascontiguousarray(ys, np.int32)
        flips = np.ascontiguousarray(flips, np.uint8)
        out_norm = np.empty((n, crop, crop, 3), np.float32)
        out_raw = np.empty((n, crop, crop, 3), np.float32)
        _lib().crop_batch_u8(srcs, n, resize, resize, crop,
                             xs.ctypes.data_as(_IP), ys.ctypes.data_as(_IP),
                             flips.ctypes.data_as(_UP),
                             out_norm.ctypes.data_as(_FP),
                             out_raw.ctypes.data_as(_FP))
        return torch.from_numpy(out_norm), torch.from_numpy(out_raw)

    def load_batch(self, paths: List[str], resize: int, crop: int,
                   xs, ys, flips):
        """load_batch's (normalized, raw) from the cache."""
        n = len(paths)
        missing: List[str] = []
        seen = set()
        for p in paths:
            k = (p, resize)
            if k in self.frames:
                self.frames.move_to_end(k)
                self.hits += 1
            else:
                self.misses += 1
                if p not in seen:
                    seen.add(p)
                    missing.append(p)
        if missing:
            for p, frame in zip(missing, self._decode(missing, resize)):
                self.frames[(p, resize)] = frame
                self.bytes += frame.nbytes
        # every frame of this batch was just touched: the LRU end holds it
        while self.bytes > self.budget and len(self.frames) > n:
            _, old = self.frames.popitem(last=False)
            self.bytes -= old.nbytes
        return self._crop([self.frames[(p, resize)] for p in paths], resize,
                          crop, xs, ys, flips)


# start-of-frame markers that carry the frame's size (not DHT C4, JPG C8
# or DAC CC, which share the range)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_hw(path: str) -> Tuple[int, int]:
    """(height, width) of a JPEG file, from its start-of-frame segment."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise IOError(f"{path} is not a JPEG file")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise IOError(f"{path}: bad JPEG marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:                   # fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # no length field
            i += 2
            continue
        if marker in _SOF:
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise IOError(f"{path}: no start-of-frame segment")


@functools.lru_cache(maxsize=1)
def _jpeg_write_lib() -> ctypes.CDLL:
    lib = nativebuild.load("jpeg_write")
    lib.encode_jpeg_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.encode_jpeg_rgb.restype = ctypes.c_int
    return lib


def encode(img: np.ndarray, quality: int, device="cpu") -> bytes:
    """(h, w, 3) uint8 RGB -> baseline JPEG bytes, encoded by libjpeg."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    cap = 2 * img.size + 65536
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    rc = _jpeg_write_lib().encode_jpeg_rgb(img.ctypes.data, h, w, quality,
                                           out.ctypes.data, cap,
                                           ctypes.byref(n))
    if rc != 0:
        raise IOError(f"libjpeg could not encode a {h}x{w} frame ({rc})")
    return out[:n.value].tobytes()
