"""What the benchmark imports, by top-level module name compared whole
(the port's name begins with the JAX package's):

- no module reached from benchmark/run.py imports jax, jaxlib, flax or
  the JAX package tcam_wsol_video_tpu;
- the reference (benchmark/reference) imports nothing of the measured
  program tcam_wsol_video_tpu_torch, nor of the harness;
- the FLOP count comes from the reference alone;
- a run on the CPU ends with none of the forbidden modules loaded."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.harness import manifest, report

BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT
JAX_SIDE = {"jax", "jaxlib", "flax", "tcam_wsol_video_tpu"}
PROGRAM = "tcam_wsol_video_tpu_torch"


def _imports(path: str):
    """Every module name an import statement of the file names,
    anywhere in it (function-level imports too)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _file_of(module: str):
    if not module.startswith("benchmark"):
        return None
    base = os.path.join(ROOT, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _reached(*starts: str):
    """{file: top-level names it imports} over the files reached."""
    seen, todo, out = set(), list(starts), {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        names = set(_imports(path))
        out[path] = {n.split(".")[0] for n in names}
        for n in names:
            f = _file_of(n)
            if f:
                todo.append(f)
    return out


def test_nothing_reached_from_run_imports_jax_or_the_jax_package():
    # the readers and runners are found by name at run time
    found = [os.path.join(BENCH, sub, f)
             for sub in ("metrics", os.path.join("harness", "runners"))
             for f in os.listdir(os.path.join(BENCH, sub))
             if f.endswith(".py")]
    reached = _reached(os.path.join(BENCH, "run.py"), *found)
    assert os.path.join(BENCH, "reference", "model.py") in reached
    for path, tops in reached.items():
        assert not tops & JAX_SIDE, (path, tops & JAX_SIDE)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        for path, tops in _reached(os.path.join(ref, f)).items():
            if not path.startswith(ref):
                continue
            assert PROGRAM not in tops and not tops & JAX_SIDE, path
            assert not any(n.startswith("benchmark.harness")
                           for n in _imports(path)), path


def test_names_are_compared_whole():
    assert "tcam_wsol_video_tpu_torch" not in report.FORBIDDEN
    assert "tcam_wsol_video_tpu" in report.FORBIDDEN


def _python(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def test_flop_count_is_independent_of_the_program():
    out = _python(
        "import sys; from benchmark.harness import flops\n"
        "f = flops.model_flops('STD_CL', 10, 2, 224)\n"
        "print(f, any(m.split('.')[0] == 'tcam_wsol_video_tpu_torch' "
        "for m in sys.modules))")
    flop, loaded = out.split()
    assert loaded == "False"
    # the encoder's convolutions and the head, counted by hand: a conv
    # is 2 k^2 cin cout h w a frame forward, twice that backward
    # (input and weight gradients; conv1's input needs none)
    assert abs(float(flop) - 2 * _hand_count()) / float(flop) < 1e-9


def _hand_count() -> float:
    """Forward FLOPs of one frame of the WSOL ResNet-50 + WGAP at 224 px,
    times 3 for forward and backward, minus conv1's input gradient."""
    convs = [(3, 64, 7, 112)]
    cin, size = 64, 56
    for planes, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 1),
                              (512, 3, 1)):
        for i in range(n):
            s = stride if i == 0 else 1
            out = size // s
            convs += [(cin, planes, 1, size), (planes, planes, 3, out),
                      (planes, planes * 4, 1, out)]
            if i == 0:
                convs.append((cin, planes * 4, 1, out))
            cin, size = planes * 4, out
    # each entry's size is its output's
    fwd = sum(2 * k * k * ci * co * hw * hw for ci, co, k, hw in convs)
    dense = 2 * 2048 * 10
    first_input_grad = 2 * 7 * 7 * 3 * 64 * 112 * 112
    return 3 * (fwd + dense) - first_input_grad


def test_a_cpu_run_loads_no_forbidden_module(tmp_path):
    out = _python(
        "import sys\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness import report\n"
        f"ctx = tiny.run(tiny.cell('stdcl_r50_wgap.stream', "
        f"compute_dtype='float32'), {str(tmp_path)!r})\n"
        "print(report.forbidden_modules(), ctx['correct'])")
    assert out.strip().splitlines()[-1] == "[] True"
