"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) is `<config>.<traffic>`; its pieces:
- benchmark/configs/<config>.json: the configuration as it is run (its
  task, the program's flags, the set it is drawn on);
- benchmark/traffic/<traffic>.json: the route's flags, what the window
  drives (`kind`, a runner in benchmark/harness/runners/<kind>.py);
- benchmark/limits/<cell>.json: the limit of each number `correct`
  compares;
- benchmark/metrics/<metric>.py: one reader per metric, `read(ctx)`,
  returning a number or None where it finds nothing to read.
A metric is reported in a cell when its `workloads` names the cell, or
when it has no `workloads`."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def reader(name: str) -> Callable:
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, section: str, cell: str) -> List[dict]:
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def cell(bench: dict, name: str) -> Dict[str, object]:
    """The cell's entry with its configuration, traffic and limits."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "entry": entry,
        "config": _json(os.path.join(ROOT, conf["file"])),
        "traffic": _json(os.path.join(BENCH_DIR, "traffic",
                                      entry["traffic"] + ".json")),
        "limits": _json(os.path.join(BENCH_DIR, "limits", name + ".json")),
        "end_to_end": metrics_of(bench, "end_to_end", name),
        "per_layer": metrics_of(bench, "per_layer", name),
    }
