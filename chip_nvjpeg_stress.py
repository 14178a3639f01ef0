"""The card's JPEG decoder under load: two processes decode the same
frames again and again, and every decode is held against the frame
decoded alone.

    python3 chip_nvjpeg_stress.py [--other X.cu ...] [--rounds N]

Each process decodes 32 synthetic frames (270 x 360, written with the
checkout's nvJPEG encoder) one after another on a side stream, without a
sync between them (data/nvjpeg_loader.load_batch's route), `rounds`
times, while a matmul keeps the card busy; its reference is each frame
decoded alone with a sync after it.  It prints the frames that differ,
for csrc/nvjpeg_codec.cu of this checkout and for each --other version
of that source (built the same way).  Needs a CUDA card; writes its
frames and libraries under build/nvjpeg_stress/.
"""
from __future__ import annotations

import argparse
import ctypes
import multiprocessing
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "nvjpeg_stress")


def _lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.nvj_image_info.argtypes = [vp, ctypes.c_size_t, vp, vp]
    lib.nvj_decode_rgbi.argtypes = [vp, ctypes.c_size_t, vp, ctypes.c_int,
                                    vp]
    return lib


def _decode(lib, path: str, stream) -> torch.Tensor:
    """One frame decoded on `stream` (its buffer allocated there)."""
    data = np.fromfile(path, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.nvj_image_info(data.ctypes.data, data.size, ctypes.byref(h),
                            ctypes.byref(w))
    if rc:
        raise RuntimeError(f"nvj_image_info {rc}")
    with torch.cuda.stream(stream):
        out = torch.empty((h.value, w.value, 3), dtype=torch.uint8,
                          device="cuda")
        rc = lib.nvj_decode_rgbi(data.ctypes.data, data.size,
                                 out.data_ptr(), 3 * w.value,
                                 stream.cuda_stream)
    if rc:
        raise RuntimeError(f"nvj_decode_rgbi {rc}")
    return out


def _worker(libpath: str, paths: list, rounds: int, q) -> None:
    lib = _lib(libpath)
    side = torch.cuda.Stream()
    ref = []
    for p in paths:
        ref.append(_decode(lib, p, side))
        torch.cuda.synchronize()
    hog = torch.randn((4096, 4096), device="cuda")
    bad = 0
    for _ in range(rounds):
        for _ in range(4):
            hog = hog @ hog.T / 4096.0
        outs = [_decode(lib, p, side) for p in paths]
        torch.cuda.synchronize()
        bad += sum(int(not torch.equal(o, r)) for o, r in zip(outs, ref))
    q.put((bad, rounds * len(paths)))


def _build(src: str, tag: str) -> str:
    from tcam_wsol_video_tpu_torch.ops.cuda import build
    lib = os.path.join(OUT, f"libnvj_{tag}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", lib, src, "-lnvjpeg"],
                   check=True, capture_output=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", nargs="*", default=[],
                    help="other versions of csrc/nvjpeg_codec.cu")
    ap.add_argument("--rounds", type=int, default=30)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_nvjpeg_stress: CUDA is not available", file=sys.stderr)
        return 2
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.ops.cuda import build
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(32):
        img = (rng.random((270, 360, 3)) * 60).astype(np.uint8)
        img[50:200, 80:300] = rng.integers(0, 255, 3)
        p = os.path.join(OUT, f"f{i}.jpg")
        with open(p, "wb") as f:
            f.write(nvjpeg_loader.encode(img, 95))
        paths.append(p)
    srcs = [("checkout", build.source("nvjpeg_codec"))] + [
        (f"other{i}", s) for i, s in enumerate(a.other)]
    for tag, src in srcs:
        lib = _build(src, tag)
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_worker, args=(lib, paths, a.rounds, q))
                 for _ in range(2)]
        for p in procs:
            p.start()
        res = [q.get(timeout=600) for _ in procs]
        for p in procs:
            p.join(60)
        print(f"[nvjpeg {tag} {src}] frames unlike their lone decode: "
              + ", ".join(f"{b} of {n}" for b, n in res), flush=True)
    shutil.rmtree(OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
