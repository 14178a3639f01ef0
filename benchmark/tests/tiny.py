"""A cell of BENCHMARK.json shrunk to a test's size: 3 classes, 12 shots
of 4 frames of 45 x 60, batch 4 at 32 px (resize 40).  Everything else,
the route's flags and the check included, is the cell's own."""
from __future__ import annotations

import copy
import time

import torch

from benchmark.harness import manifest, report
from benchmark.harness.runners import train

SET = {"n_classes": 3, "n_videos_per_class": 2, "n_shots_per_video": 2,
       "n_frames_per_shot": 4, "frame_hw": [45, 60]}
FLAGS = {"crop_size": 32, "resize_size": 40, "batch_size": 4,
         "num_classes": 3}


def cell(name: str, **flags) -> dict:
    c = copy.deepcopy(manifest.cell(manifest.load(), name))
    c["config"]["flags"].update(FLAGS, **flags)
    c["config"]["set"] = dict(SET)
    return c


def run(c: dict, work: str, seed: int = 2 ** 31 + 7, device="cpu",
        **kw) -> dict:
    """The runner's context and the result's checks."""
    torch.set_num_threads(2)
    ctx = train.run(c, seed, 0.05, False, torch.device(device),
                    time.perf_counter(), work, **kw)
    ctx["checks"] = report.checks(c, ctx["numbers"]["program"])
    ctx["correct"] = report.is_correct(ctx["checks"])
    return ctx
