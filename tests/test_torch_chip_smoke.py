"""chip_smoke.py's two refusals, which a machine without a card can show:
in the checkout it exits 2 without CUDA, and copied alone into a folder
without the rest of the checkout it exits 1 (the port's package cannot
be imported) on any machine; neither prints a result line.  (On a card,
from a checkout, it exits 0.)"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the script would run")
    out = _run(ROOT)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == "" and "CUDA is not available" in out.stderr


def test_chip_smoke_alone_fails_without_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode == 1, out.stderr[-2000:]
    assert out.stdout == ""
    assert "ModuleNotFoundError" in out.stderr
    assert "tcam_wsol_video_tpu_torch" in out.stderr
