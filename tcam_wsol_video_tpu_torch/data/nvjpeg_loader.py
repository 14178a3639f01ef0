"""The card's image route (data/image_route.py): nvJPEG decode and encode
(csrc/nvjpeg_codec.cu, bound with ctypes) in device memory, then the
resize, crop, flip and ImageNet normalization of native/fastloader.cpp as
PyTorch ops on the card.  Every batch decodes on a side stream, frames of
one size together (`_decode_by_size`).

`resize_crop_normalize` repeats fastloader's arithmetic: half-pixel
bilinear sampling positions computed in float32 as the C code computes
them, the same interpolation order, then crop, flip and (v / 255 - mean) /
std.  It runs on any device, so the CPU tests hold it against fastloader.
nvJPEG's decoder is not libjpeg's: its frames differ from the host route's
by a few levels (chip_smoke.py holds both routes' round trips against the
source frames).  `decode_resize_u8` is fastloader's decode_resize_batch on
the card (the resize rounded half up to uint8), `crop_normalize_u8` its
crop_batch_u8, and `DeviceFrameCache` the decoded-frame cache on the
card.  `load_resized_u8` is the CAM dump's route: whole frames resized
with Pillow's bilinear arithmetic (data/transforms.py).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.data import native_loader
from tcam_wsol_video_tpu_torch.data.transforms import (crop_flip,
                                                       imagenet_stats,
                                                       pil_bilinear_resize)
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


def resize_fastloader(frames: torch.Tensor, resize: int) -> torch.Tensor:
    """frames (N, h, w, 3) uint8 -> (N, resize, resize, 3) float32, the
    bilinear resize of fastloader.cpp, on the frames' device."""
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
    return top + (bot - top) * wy[None, :, None, None]


def _normalize(raw: torch.Tensor) -> torch.Tensor:
    """fastloader's (v / 255 - mean) / std in float32."""
    mean, std = imagenet_stats(raw.device)
    return (raw / 255.0 - mean) / std


def resize_crop_normalize(frames: torch.Tensor, resize: int, crop: int,
                          xs: Sequence[int], ys: Sequence[int],
                          flips: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (N, h, w, 3) uint8 -> (normalized, raw) (N, crop, crop, 3)
    float32 on the frames' device: resize to (resize, resize), crop at
    (ys[i], xs[i]), flip where flips[i]."""
    raw = crop_flip(resize_fastloader(frames, resize), crop, ys, xs, flips)
    return _normalize(raw), raw


def crop_normalize_u8(frames: torch.Tensor, crop: int, xs: Sequence[int],
                      ys: Sequence[int], flips: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fastloader's crop_batch_u8 on the frames' device: frames
    (N, r, r, 3) uint8 -> (normalized, raw) (N, crop, crop, 3) float32."""
    raw = crop_flip(frames, crop, ys, xs, flips).float()
    return _normalize(raw), raw


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def _decode_by_size(paths: List[str], device, fn
                    ) -> Tuple[torch.Tensor, ...]:
    """Decode each file with nvJPEG and apply fn(frames (n, h, w, 3)
    uint8, ids) to the frames of each size (ids indexes their places in
    `paths`), on a stream of its own, so that the decodes never wait for
    the work queued on the caller's stream.  Returns fn's tensors with
    the rows of every size in their places; the caller's stream waits for
    the side stream, and each tensor is recorded on it."""
    device = _cuda(device)
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    with torch.cuda.stream(side):
        frames = [decode(p, device) for p in paths]
        groups: dict = {}
        for i, f in enumerate(frames):
            groups.setdefault(tuple(f.shape), []).append(i)
        if len(groups) == 1:
            out = fn(torch.stack(frames), slice(None))
        else:
            parts = [(ids, fn(torch.stack([frames[i] for i in ids]), ids))
                     for ids in groups.values()]
            out = tuple(t.new_empty((len(frames), *t.shape[1:]))
                        for t in parts[0][1])
            for ids, res in parts:
                for o, t in zip(out, res):
                    o[ids] = t
    main.wait_stream(side)
    for t in out:
        t.record_stream(main)
    return out


def load_batch(paths: List[str], resize: int, crop: int,
               xs: Sequence[int], ys: Sequence[int], flips: Sequence[int],
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """fastloader's load_batch on the card: (normalized, raw) tensors
    (N, crop, crop, 3) on `device`, decoded and resized on the side
    stream, frames of one size together."""
    xs, ys, flips = (np.asarray(v) for v in (xs, ys, flips))
    return _decode_by_size(paths, device, lambda f, ids: (
        resize_crop_normalize(f, resize, crop, xs[ids], ys[ids],
                              flips[ids])))


def decode_resize_u8(paths: List[str], resize: int, device="cuda"
                     ) -> torch.Tensor:
    """fastloader's decode_resize_batch on the card: each file decoded by
    nvJPEG, resized with fastloader's taps and rounded half up (v + 0.5
    truncated) -> (N, resize, resize, 3) uint8 on `device`, on the side
    stream."""
    return _decode_by_size(paths, device, lambda f, ids: (
        (resize_fastloader(f, resize) + 0.5).clamp_(max=255.0).to(
            torch.uint8),))[0]


def load_resized_u8(paths: List[str], size: Tuple[int, int],
                    device="cuda") -> torch.Tensor:
    """Decode each file on the card and resize the whole frame to `size`
    as Pillow's BILINEAR does: (N, h, w, 3) uint8 on `device`, on the
    side stream."""
    return _decode_by_size(paths, device, lambda f, ids: (
        pil_bilinear_resize(f, size),))[0]


class DeviceFrameCache(native_loader.DecodedFrameCache):
    """The decoded-frame cache on the card: the host cache's budget, dedup,
    counting and eviction, with the frames in device memory, filled by
    decode_resize_u8 and cropped by crop_normalize_u8."""

    def __init__(self, budget_mb: int, device="cuda"):
        super().__init__(budget_mb)
        self.device = _cuda(device)

    def _decode(self, paths: List[str], resize: int) -> list:
        return [f.clone() for f in decode_resize_u8(paths, resize,
                                                    self.device)]

    def _crop(self, frames: list, resize: int, crop: int, xs, ys, flips):
        return crop_normalize_u8(torch.stack(frames), crop, xs, ys, flips)


def frame_cache(budget_mb: int, device="cuda") -> DeviceFrameCache:
    """The decoded-frame cache of the card's route."""
    return DeviceFrameCache(budget_mb, device)
