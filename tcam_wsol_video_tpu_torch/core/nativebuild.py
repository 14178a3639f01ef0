"""Build the host C++ libraries the port binds with ctypes.

    fastloader  native/fastloader.cpp  (libjpeg decode, resize, crop, flip)
    boxsweep    native/boxsweep.cpp    (all-threshold contour-box sweep)
    jpeg_write  csrc/jpeg_write.cpp    (libjpeg JPEG writer)
    contours    csrc/contours.cpp      (border following, cv2's contours)
    bilateral_grid  native/bilateral_grid.cpp  (CPU bilateral filter)

Each is compiled by g++ with the JAX package's flags (-O3 -march=native
-fopenmp -shared -fPIC), so that both packages' libraries compute the same
bits, into build/native/ at first use.  The file name carries a tag of
this host's CPU: a -march=native library copied from another machine is
never loaded.  A missing compiler or header raises, naming it; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import time
from typing import Dict, Iterable

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
# name -> (source, link flags)
LIBS = {
    "fastloader": (os.path.join(_REPO, "native", "fastloader.cpp"),
                   ["-ljpeg"]),
    "boxsweep": (os.path.join(_REPO, "native", "boxsweep.cpp"), []),
    "jpeg_write": (os.path.join(_REPO, "tcam_wsol_video_tpu_torch", "csrc",
                                "jpeg_write.cpp"), ["-ljpeg"]),
    "contours": (os.path.join(_REPO, "tcam_wsol_video_tpu_torch", "csrc",
                              "contours.cpp"), []),
    "bilateral_grid": (os.path.join(_REPO, "native", "bilateral_grid.cpp"),
                       []),
}


@functools.lru_cache(maxsize=1)
def host_tag() -> str:
    """Machine type and a hash of the CPU flags."""
    flags = ""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith(("flags", "Features")):
                flags = " ".join(sorted(line.split(":", 1)[1].split()))
                break
    digest = hashlib.sha256(f"{platform.machine()}|{flags}".encode())
    return f"{platform.machine()}-{digest.hexdigest()[:8]}"


def library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{host_tag()}.so")


def _up_to_date(name: str) -> bool:
    lib = library(name)
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(LIBS[name][0]))


def _failure(name: str, log: str) -> str:
    if "jpeglib.h" in log or "-ljpeg" in log:
        why = "libjpeg (jpeglib.h and libjpeg.so) is missing on this host"
    else:
        why = "g++ failed"
    return f"cannot build {name} from {LIBS[name][0]}: {why}:\n{log}"


def build_all(names: Iterable[str] = tuple(LIBS),
              force: bool = False) -> Dict[str, dict]:
    """Compile each library that is not up to date, all g++ processes
    started together.  Returns {name: {'seconds', 'log'}}."""
    names = [n for n in names if force or not _up_to_date(n)]
    if not names:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    try:
        for n in names:
            src, link = LIBS[n]
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.Popen(["g++", *CXX_FLAGS, src, *link, "-o",
                                         tmp], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except FileNotFoundError as e:
                os.remove(tmp)
                raise RuntimeError(f"cannot build {n}: g++ is not on the "
                                   "PATH") from e
            jobs[n] = (proc, tmp)
        out = {}
        for n, (proc, tmp) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(_failure(n, log))
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
    """The library `name`, built first if needed."""
    build_all([name])
    return ctypes.CDLL(library(name))
