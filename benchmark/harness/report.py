"""The result line of a run, and the numbers `correct` compared."""
from __future__ import annotations

import json
import sys
from typing import Dict

from benchmark.harness import manifest

# modules no run may hold once its window has closed: JAX and the JAX
# package (top-level names compared whole: the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tcam_wsol_video_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checks(cell: dict, numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each limit of the cell with the run's number (None where the run
    gave none, which fails)."""
    return {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in cell["limits"].items()}


def is_correct(chk: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in chk.values())


def result(cell: dict, ctx: dict, trace: bool, device: dict) -> dict:
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    chk = checks(cell, ctx["numbers"]["program"])
    out = {"correct": is_correct(chk), "attempted": ctx["steps"],
           "failed": ctx["failed"], "metrics": metrics, "device": device}
    if trace and ctx.get("trace"):
        out["device"] = {**device, "busy_s": ctx["trace"]["busy_s"],
                         "window_s": ctx["trace"]["window_s"]}
        out["breakdown"] = ctx["trace"]["breakdown"]
    out["checks"] = chk
    return out


def emit(res: dict, numbers: Dict[str, float]) -> None:
    """Every number the check computed, then the compared ones with their
    limits as the last lines of stderr; the result as the last line of
    stdout."""
    print("numbers " + json.dumps({k: v for k, v in numbers.items()
                                   if k != "look"}), file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(res), flush=True)
