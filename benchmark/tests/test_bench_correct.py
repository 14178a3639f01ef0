"""`correct` on the CPU at a test's size: a sound run of each cell is
correct, and each fault a training cell can have, planted under the timed
path, are not; nor is the data plane's control (the reference one
precision down in the program's place).  The program runs its steps in fp32 here: at 32 px and
batch 4 the recipe's bf16 strays further from fp32 than at the cell's
size, where the limits were set (PERF.md)."""
from __future__ import annotations

import pytest

from benchmark.harness import report
from benchmark.tests import tiny

CELLS = ("tcam_r50_exact.feed", "stdcl_r50_wgap.stream",
         "tcam_r50_exact.stream")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    ctx = tiny.run(tiny.cell(name, compute_dtype="float32"), str(tmp_path))
    assert ctx["tapped_calls"] >= 3
    assert ctx["correct"], ctx["checks"]


@pytest.mark.parametrize("fault", ("state_unchanged", "half_batch",
                                   "half_loss"))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, tmp_path):
    ctx = tiny.run(tiny.cell(name, compute_dtype="float32"), str(tmp_path),
                   fault=fault)
    assert not ctx["correct"], ctx["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_data_control_is_not_correct(name, tmp_path):
    """The data plane's control (4-bit pixels; TCAM: bf16 CAMs and ROIs)
    fails the data plane's limits at any size.  The steps' control is
    held at the cell's own size on the card (test_bench_card.py): at
    32-64 px its fp8 steps move the compared numbers by about as much
    as the limits set at 224 px allow (PERF.md)."""
    c = tiny.cell(name, compute_dtype="float32")
    ctx = tiny.run(c, str(tmp_path), calibrate=True, alternates=())
    chk = {k: v for k, v in report.checks(
        c, ctx["numbers"]["control_data"]).items() if v["value"] is not None}
    assert chk and not report.is_correct(chk), chk
