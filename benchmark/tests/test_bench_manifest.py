"""BENCHMARK.json against the benchmark's contract, and every cell against
the files the harness finds by name."""
from __future__ import annotations

import os
import re

import pytest

from benchmark.harness import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
RUN_LIMIT_S = 43200
MAX_CELLS = 24


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")
                           ) <= 64 * 1024


def test_a_full_check_fits_at_this_run_length():
    runs = 2 + 14 * MAX_CELLS
    total = (runs * (BENCH["run_seconds"] + 60) + MAX_CELLS * 2 * 90
             + 1200)
    assert total <= RUN_LIMIT_S


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for k in c["reduced"]:
            assert NAME.match(k), k
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_file_names_under_paths():
    for path in BENCH["paths"]:
        for d, _, files in os.walk(os.path.join(manifest.ROOT, path)):
            if "__pycache__" in d:
                continue
            for f in files:
                if f.endswith(".pyc"):
                    continue
                rel = os.path.relpath(os.path.join(d, f), manifest.ROOT)
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    c = manifest.cell(BENCH, name)
    conf = next(x for x in BENCH["configs"]
                if x["name"] == c["entry"]["config"])
    assert c["config"]["name"] == conf["name"]
    assert c["config"]["source"] == conf["source"]
    assert c["config"]["reduced"] == conf["reduced"]
    assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "harness",
                                       "runners",
                                       c["traffic"]["kind"] + ".py"))
    assert c["limits"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_names_an_end_to_end_metric_of_the_same_cells(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    target = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    cells = m.get("workloads", CELLS)
    for cell in cells:
        assert cell in CELLS
        assert "workloads" not in target or cell in target["workloads"]


def test_layers_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert all(layer == layer.strip() for layer in layers)


def _recipe(path: str) -> dict:
    """The `key: value` lines of a flat recipe yaml, comments dropped."""
    out = {}
    with open(os.path.join(manifest.ROOT, path)) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                k, v = (s.strip() for s in line.split(":", 1))
                out[k] = v
    return out


def _same(a, b) -> bool:
    try:
        return float(a) == float(b)
    except ValueError:
        return str(a).lower() == str(b).lower()


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_holds_its_recipe(conf):
    """A configuration's flags are its recipe yaml's keys, value for value,
    and the keys it names under `added`: the copy cannot drift from the
    yaml unnoticed."""
    cfg = manifest._json(os.path.join(manifest.ROOT, conf["file"]))
    recipe = _recipe(cfg["recipe_file"])
    flags = cfg["flags"]
    assert set(flags) == set(recipe) | set(cfg["added"])
    assert not set(recipe) & set(cfg["added"])
    for k, v in recipe.items():
        assert _same(flags[k], v), (k, flags[k], v)
