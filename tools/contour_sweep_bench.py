"""Host time of the single-largest-contour (and multi-contour) box sweep:
the JAX package's cv2 loop (metrics/wsol.scoremap_to_boxes) against the
port's border follower (tcam_wsol_video_tpu_torch/ops/contours.py via its
metrics/wsol.scoremap_to_boxes), on the same blurred CAM-like maps at
224 px, tau by tau at cam_curve_interval 0.001 (1000 taus).  The boxes are
checked equal first.  CPU only; run with JAX on the CPU:

    JAX_PLATFORMS=cpu python tools/contour_sweep_bench.py [--maps 8]

Prints one JSON line: ms per image of each, per protocol, and the host.
"""
import argparse
import json
import os
import platform
import sys
import time

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tcam_wsol_video_tpu.metrics import wsol as jwsol  # noqa: E402
from tcam_wsol_video_tpu_torch.metrics import wsol  # noqa: E402


def blurred(seed: int, size: int = 224) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = cv2.GaussianBlur(rng.random((size, size)).astype(np.float32),
                         (0, 0), float(rng.uniform(2, 12)))
    return ((m - m.min()) / (m.max() - m.min())).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--interval", type=float, default=0.001)
    a = ap.parse_args()
    cv2.setNumThreads(1)
    taus = np.arange(0.0, 1.0, a.interval)
    maps = [blurred(s) for s in range(a.maps)]
    out = {"host": platform.processor() or platform.machine(),
           "cv2": cv2.__version__, "taus": len(taus), "maps": len(maps)}
    for multi in (False, True):
        for m in maps:
            want, _ = jwsol.scoremap_to_boxes(m, taus, multi)
            got, _ = wsol.scoremap_to_boxes(m, taus, multi)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        name = "multi" if multi else "single"
        for side, fn in (("jax_cv2", jwsol.scoremap_to_boxes),
                         ("port", wsol.scoremap_to_boxes)):
            t0 = time.perf_counter()
            for m in maps:
                fn(m, taus, multi)
            out[f"{name}_{side}_ms_per_image"] = (
                (time.perf_counter() - t0) * 1e3 / len(maps))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
