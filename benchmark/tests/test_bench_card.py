"""The cells on the card: at a test's size, the card's routes (nvJPEG,
the exact CRF kernel, the chunked route's CUDA graphs) through the
harness, judged by the reference; at the cell's own size, the control
(the reference's steps in fp8 in the program's place) is not correct.
Skipped without CUDA."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import manifest, report
from benchmark.tests import tiny
from benchmark.tests.test_bench_correct import CELLS


@pytest.fixture
def card():
    """The card, with TF32 off: the program runs these steps in fp32,
    and the tiny models' three steps amplify TF32's rounding past the
    cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card_is_correct(card, name, tmp_path):
    ctx = tiny.run(tiny.cell(name, compute_dtype="float32"), str(tmp_path),
                   device=card)
    assert ctx["correct"], ctx["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_on_the_card_is_not_correct(card, name, tmp_path):
    ctx = tiny.run(tiny.cell(name, compute_dtype="float32"), str(tmp_path),
                   device=card, fault="state_unchanged")
    assert not ctx["correct"], ctx["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_at_the_cells_size_is_not_correct(card, name, tmp_path):
    c = manifest.cell(manifest.load(), name)
    ctx = tiny.run(c, str(tmp_path), seed=2 ** 31 + 11, device=card,
                   calibrate=True, alternates=("control",))
    chk = {k: v for k, v in report.checks(
        c, ctx["numbers"]["control"]).items() if v["value"] is not None}
    assert set(chk) - {"rows"}, chk
    assert not report.is_correct(chk), chk
