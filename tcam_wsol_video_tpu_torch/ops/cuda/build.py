"""Build and load the port's CUDA kernels.

Every source csrc/<name>.cu is compiled the same way: nvcc for sm_90a
(plus the source's libraries in LINK) into a shared library with a plain
C interface,
build/kernels/libtcam_<name>.so, at first use, and loaded with ctypes.
Each C entry point takes device pointers and the stream as void* and
returns cudaGetLastError() after its launches; the Python wrappers raise
when it is not 0.  `build_all` starts one nvcc per source at once and
waits for all of them.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Sequence

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CSRC = os.path.join(_REPO, "tcam_wsol_video_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
SOURCES = ("bilateral", "landmarks", "nvjpeg_codec")
# link flags of a source beyond the CUDA runtime
LINK = {"nvjpeg_codec": ["-lnvjpeg"]}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# every LaunchCounter made, so that a CUDA graph's launches can be counted
# per replay (engine/scan_train.py)
COUNTERS: list = []


class LaunchCounter:
    """Kernel launches (and plain-version calls) since the last reset.  A
    wrapper counts where it launches; a CUDA graph that captured it counts
    its capture's launches again at each replay."""

    def __init__(self):
        self.kernel = 0
        self.plain = 0
        COUNTERS.append(self)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libtcam_{name}.so")


def _up_to_date(name: str) -> bool:
    lib = library(name)
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(source(name)))


def build_all(names: Iterable[str] = SOURCES,
              force: bool = False) -> Dict[str, dict]:
    """Compile each csrc/<name>.cu that is not up to date, all nvcc
    processes started together.  Returns {name: {'seconds', 'log'}}, the
    log holding nvcc's and ptxas' report (registers, shared memory)."""
    names = [n for n in names if force or not _up_to_date(n)]
    if not names:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    jobs = {}
    t0 = time.perf_counter()
    try:
        for n in names:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, source(n),
                                     *LINK.get(n, [])],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp)
        out = {}
        for n, (proc, tmp) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {n}.cu "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, library(n))
            out[n] = {"seconds": time.perf_counter() - t0,
                      "log": log.strip()}
        return out
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library of csrc/<name>.cu, built first if needed."""
    build_all([name])
    return ctypes.CDLL(library(name))


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int):
    """Declare a C entry point (n_ptr pointers, n_int ints, then the
    stream) returning int.  Pointers and the stream are c_void_p: a bare
    Python int would be passed as a 32-bit int and cut."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def pad_last(x: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """Zero-pad the last axis up to the next width a kernel is
    instantiated for (zero feature columns change no distance, zero value
    columns give zero outputs)."""
    n = x.shape[-1]
    target = next(w for w in widths if w >= n)
    if target == n:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, target - n)).contiguous()
