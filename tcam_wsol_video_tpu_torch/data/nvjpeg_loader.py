"""The card's image route: nvJPEG decode (csrc/nvjpeg_codec.cu, bound with
ctypes) into device memory, then the resize, crop, flip and ImageNet
normalization of native/fastloader.cpp as PyTorch ops on the card.

`resize_crop_normalize` repeats fastloader's arithmetic: half-pixel
bilinear sampling positions computed in float32 as the C code computes
them, the same interpolation order, then crop, flip and (v / 255 - mean) /
std.  It runs on any device, so the CPU tests hold it against fastloader.
nvJPEG's decoder is not libjpeg's: its frames differ from the host route's
by a few levels (chip_smoke.py holds both routes' round trips against the
source frames).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.ops.cuda import build

_VP = ctypes.c_void_p


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("nvjpeg_codec")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.nvj_image_info.argtypes = [_VP, ctypes.c_size_t, ip, ip]
    lib.nvj_decode_rgbi.argtypes = [_VP, ctypes.c_size_t, _VP, ctypes.c_int,
                                    _VP]
    lib.nvj_encode_rgbi.argtypes = [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t), _VP]
    for fn in (lib.nvj_image_info, lib.nvj_decode_rgbi, lib.nvj_encode_rgbi):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvJPEG {what} failed with code {rc} (1000 + "
                           "nvjpegStatus_t, 2000 + cudaError_t)")


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG runs on a CUDA device, not {device}")
    return device


def decode(path: str, device="cuda") -> torch.Tensor:
    """One JPEG file -> (h, w, 3) uint8 RGB on the card."""
    device = _cuda(device)
    data = np.fromfile(path, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    lib = _lib()
    _check(lib.nvj_image_info(data.ctypes.data, data.size, ctypes.byref(h),
                              ctypes.byref(w)), f"header of {path}")
    out = torch.empty((h.value, w.value, 3), dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib.nvj_decode_rgbi(data.ctypes.data, data.size,
                                   out.data_ptr(), 3 * w.value, stream),
               f"decode of {path}")
    return out


def encode(img: np.ndarray, quality: int, device="cuda") -> bytes:
    """(h, w, 3) uint8 RGB -> baseline JPEG bytes (4:2:0), encoded on the
    card."""
    device = _cuda(device)
    h, w, _ = img.shape
    src = torch.from_numpy(np.ascontiguousarray(img, np.uint8)).to(device)
    cap = 2 * img.size + 65536
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().nvj_encode_rgbi(src.data_ptr(), h, w, 3 * w, quality,
                                      out.ctypes.data, cap, ctypes.byref(n),
                                      stream), "encode")
    return out[:n.value].tobytes()


@functools.lru_cache(maxsize=16)
def _taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fastloader's sampling along one axis: i0, i1 and the weight of i1,
    computed in float32 as (o + 0.5f) * src / dst - 0.5f, clamped."""
    o = np.arange(dst, dtype=np.float32)
    f = (o + np.float32(0.5)) * np.float32(src) / np.float32(dst)
    f = np.clip(f - np.float32(0.5), np.float32(0), np.float32(src - 1))
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, (f - i0.astype(np.float32)).astype(np.float32)


def resize_crop_normalize(frames: torch.Tensor, resize: int, crop: int,
                          xs: Sequence[int], ys: Sequence[int],
                          flips: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (N, h, w, 3) uint8 -> (normalized, raw) (N, crop, crop, 3)
    float32 on the frames' device: resize to (resize, resize), crop at
    (ys[i], xs[i]), flip where flips[i]."""
    n, h, w, _ = frames.shape
    dev = frames.device
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _taps(h, resize))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _taps(w, resize))
    v = frames.float()
    top = v[:, y0]
    bot = v[:, y1]
    wx = wx[None, None, :, None]
    top = top[:, :, x0] + (top[:, :, x1] - top[:, :, x0]) * wx
    bot = bot[:, :, x0] + (bot[:, :, x1] - bot[:, :, x0]) * wx
    resized = top + (bot - top) * wy[None, :, None, None]
    raw = torch.stack([
        resized[i, y:y + crop, x:x + crop].flip(1) if f
        else resized[i, y:y + crop, x:x + crop]
        for i, (x, y, f) in enumerate(zip(xs, ys, flips))]).contiguous()
    mean = torch.tensor(constants.IMAGENET_MEAN, dtype=torch.float32,
                        device=dev)
    std = torch.tensor(constants.IMAGENET_STD, dtype=torch.float32,
                       device=dev)
    return (raw / 255.0 - mean) / std, raw


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def load_batch(paths: List[str], resize: int, crop: int,
               xs: Sequence[int], ys: Sequence[int], flips: Sequence[int],
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """fastloader's load_batch on the card: (normalized, raw) tensors
    (N, crop, crop, 3) on `device`.  The batch is decoded and resized on a
    stream of its own, so that it never waits for the work queued on the
    caller's stream; the caller's stream waits for it.  Frames of one size
    are resized together."""
    device = _cuda(device)
    main = torch.cuda.current_stream(device)
    with torch.cuda.stream(_side_stream(device)):
        frames = [decode(p, device) for p in paths]
        if len({tuple(f.shape) for f in frames}) == 1:
            norm, raw = resize_crop_normalize(torch.stack(frames), resize,
                                              crop, xs, ys, flips)
        else:
            parts = [resize_crop_normalize(f[None], resize, crop, [x], [y],
                                           [fl])
                     for f, x, y, fl in zip(frames, xs, ys, flips)]
            norm = torch.cat([p[0] for p in parts])
            raw = torch.cat([p[1] for p in parts])
    main.wait_stream(_side_stream(device))
    norm.record_stream(main)
    raw.record_stream(main)
    return norm, raw
