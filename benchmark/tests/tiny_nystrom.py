"""tests/tiny.py's run for a landmark-CRF cell: the same tiny cell, driven
through the cell's own runner (harness/runners/train_nystrom.py), which
holds the program to the reference's Nystrom filter."""
from __future__ import annotations

import time

import torch

from benchmark.harness import report
from benchmark.harness.runners import train_nystrom

CELL = "tcam_r50_landmarks.feed_nystrom"


def run(c: dict, work: str, seed: int = 2 ** 31 + 7, device="cpu",
        **kw) -> dict:
    """The runner's context and the result's checks."""
    torch.set_num_threads(2)
    ctx = train_nystrom.run(c, seed, 0.05, False, torch.device(device),
                            time.perf_counter(), work, **kw)
    ctx["checks"] = report.checks(c, ctx["numbers"]["program"])
    ctx["correct"] = report.is_correct(ctx["checks"])
    return ctx
