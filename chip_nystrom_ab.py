"""Time the Nystrom passes of csrc/landmarks.cu against variants of it on
one NVIDIA GPU, in turns within one process.

    python3 chip_nystrom_ab.py [--other PATH/NAME.cu ...]

Variants, each built by nvcc from an edited copy of the source (all built
at once, under build/ab/):
  this      the checkout's csrc/landmarks.cu as it is;
  no_ex2    the weight is min(e, 0) itself: no MUFU work (wrong numbers,
            timing only);
  no_mma    the exponent without its cross term (the norms alone): no
            tensor-core work (wrong numbers, timing only);
  NAME      each file given by --other (another version of the kernels
            with the same C entry points), named by its file name.
A variant whose edit no longer applies to the source is skipped.  Inputs
are path B's (B = 32, 224 x 224 pixels, M = 1024 grid landmarks, D = 5,
K = 2).  Each variant's passes are timed with CUDA events over 20 calls,
in turns (the variants in order, then in reverse).  Prints the card's
name and power limit, one line per variant, and writes
chiprun_out/nystrom_ab.json.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "tcam_wsol_video_tpu_torch", "csrc", "landmarks.cu")
OUT_DIR = os.path.join(ROOT, "build", "ab")
EX2 = "w[i] = ex2_approx(fminf(e[i], 0.f));"
MMA = "mma_f16(e, afr[r][s], bfr[s][0], bfr[s][1]);"
EDITS = {
    "this": [],
    "no_ex2": [(EX2, "w[i] = fminf(e[i], 0.f);")],
    "no_mma": [(MMA, "{}")],
}


def build_variants(others: list) -> dict:
    """{name: .so path}, one nvcc per variant, started together."""
    from tcam_wsol_video_tpu_torch.ops.cuda import build
    src = open(SRC).read()
    sources = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                print(f"[ab] {name}: edit does not apply; skipped",
                      flush=True)
                text = None
                break
            text = text.replace(old, new)
        if text is not None:
            sources[name] = text
    for path in others:
        sources[os.path.splitext(os.path.basename(path))[0]] = open(
            path).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = so
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another landmarks.cu to time beside this one "
                         "(repeatable)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_nystrom_ab: CUDA is not available", file=sys.stderr)
        return 2
    from tcam_wsol_video_tpu_torch.ops import crf, linalg
    from tcam_wsol_video_tpu_torch.ops.cuda import build, landmarks

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    fns = {}
    for name, so in build_variants(a.other).items():
        lib = ctypes.CDLL(so)
        fns[name] = (build.bind(lib, "landmarks_nystrom_rhs", 5, 6),
                     build.bind(lib, "landmarks_nystrom_out", 4, 5))

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, w = 32, 224, 224
    img = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
    feats = crf.make_bilateral_features(img, 15.0, 100.0)
    feats = (feats - feats.mean(1, keepdim=True)).contiguous()
    idx = torch.from_numpy(crf._landmark_grid_indices(h, w, 1024)).cuda()
    fm = feats[:, idx].contiguous()
    vals = torch.softmax(torch.randn((b, h * w, 2), generator=gen,
                                     device="cuda"), -1).contiguous()
    p, d, m = feats.shape[1], feats.shape[2], fm.shape[1]
    kmm = landmarks.add_ridge(landmarks.build_knm(fm, fm), 1e-2)
    alpha = linalg.batched_cholesky_solve(
        kmm, landmarks.nystrom_rhs_plain(feats, fm, vals)).contiguous()
    want_rhs = landmarks.nystrom_rhs_plain(feats, fm, vals)
    want_out = landmarks.nystrom_out_plain(feats, fm, alpha)
    nsplit = landmarks.rhs_splits(b, p, m)
    part = torch.empty((b, nsplit, m, 2), device="cuda")
    rhs = torch.empty((b, m, 2), device="cuda")
    out = torch.empty((b, p, 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def calls(name):
        f_rhs, f_out = fns[name]

        def run_rhs():
            err = f_rhs(feats.data_ptr(), fm.data_ptr(), vals.data_ptr(),
                        part.data_ptr(), rhs.data_ptr(), b, p, m, d, 2,
                        nsplit, stream)
            if err:
                raise RuntimeError(f"{name}: rhs launch failed ({err})")

        def run_out():
            err = f_out(feats.data_ptr(), fm.data_ptr(), alpha.data_ptr(),
                        out.data_ptr(), b, p, m, d, 2, stream)
            if err:
                raise RuntimeError(f"{name}: out launch failed ({err})")
        return run_rhs, run_out

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    res = {name: {"rhs_ms": [], "out_ms": []} for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            run_rhs, run_out = calls(name)
            res[name]["rhs_ms"].append(ms(run_rhs))
            res[name]["out_ms"].append(ms(run_out))
    for name in fns:
        run_rhs, run_out = calls(name)
        run_rhs()
        run_out()
        torch.cuda.synchronize()
        r = res[name]
        r["rhs_rel_err"] = ((rhs - want_rhs).abs().max()
                            / want_rhs.abs().max()).item()
        r["out_rel_err"] = ((out - want_out).abs().max()
                            / want_out.abs().max()).item()
        print(f"[ab] {name}: rhs {' / '.join(f'{t:.4f}' for t in r['rhs_ms'])}"
              f" ms, out {' / '.join(f'{t:.4f}' for t in r['out_ms'])} ms; "
              f"rel err vs plain rhs {r['rhs_rel_err']:.3e}, out "
              f"{r['out_rel_err']:.3e}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "nystrom_ab.json"), "w") as f:
        json.dump({"device": smi, "shape": [b, p, d, m, 2], "variants": res},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
