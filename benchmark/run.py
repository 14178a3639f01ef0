"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell named in BENCHMARK.json on the card it starts on, prints the
numbers `correct` compared (each with its limit) as the last lines of
stderr and one JSON result as the last line of stdout.  --trace 0 reports
the cell's end-to-end metrics, --trace 1 its per-layer ones.  Exits 2
without CUDA or with fewer cards than the cell asks for, and 3 when JAX
or the JAX package is loaded once the window has closed.

Calibration (not a run of the benchmark): --calibrate 1 --seeds a,b,...
runs the cell once a seed in one process and prints, per seed, the
program's numbers with the leaves behind them and, on the first
--alternates seeds (all by default), the control's, the witness's and
the planted faults' (README.md).  --witness fp32 runs the program in
fp32 with TF32 off instead of the configuration's precision.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "bench")
# the program's build caches stay in the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, choices=(0, 1), default=0)
    p.add_argument("--seeds", default="")
    p.add_argument("--alternates", type=int, default=-1)
    p.add_argument("--witness", choices=("", "fp32"), default="")
    return p.parse_args(argv)


def device_info(torch, device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def main(argv=None) -> int:
    ns = parse(argv)
    from benchmark.harness import manifest, report
    cell = manifest.cell(manifest.load(ROOT), ns.workload)
    import torch
    chips = int(cell["entry"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{ns.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runner = importlib.import_module(
        f"benchmark.harness.runners.{cell['traffic']['kind']}")
    work = os.path.join(WORK, ns.workload)
    if ns.calibrate:
        from benchmark.harness import check
        seeds = [int(s) for s in ns.seeds.split(",")] if ns.seeds else [
            ns.seed]
        flags = None
        if ns.witness == "fp32":
            flags = {"compute_dtype": "float32"}
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            ctx = runner.run(cell, seed, ns.seconds, False, device, t0, work,
                             calibrate=True, flags=flags,
                             alternates=check.ALTERNATES
                             if ns.alternates < 0 or i < ns.alternates
                             else ())
            print(json.dumps({"seed": seed, "witness": ns.witness,
                              "limits": cell["limits"],
                              **ctx["numbers"], "setup_s": ctx["setup_s"],
                              "check_s": ctx["check_s"]}), flush=True)
            del ctx
        return 0
    ctx = runner.run(cell, ns.seed, ns.seconds, bool(ns.trace), device,
                     T_START, work)
    info = {**device_info(torch, device),
            "memory_peak_bytes": ctx["memory_peak_bytes"]}
    res = report.result(cell, ctx, bool(ns.trace), info)
    if ns.trace:
        from benchmark.harness.trace import groups
        print("device seconds by kernel group: " + json.dumps(
            groups(ctx["trace"])), file=sys.stderr)
    found = report.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    report.emit(res, ctx["numbers"]["program"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
