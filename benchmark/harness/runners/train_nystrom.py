"""The training runner of a landmark-CRF configuration: runners/train.py
with the reference's CRF term bound to the Nystrom filter.

The configuration's `crf_impl` must be `landmarks`.  For the length of
train.run (its check included) reference/losses.crf is
reference/nystrom.crf at the configuration's `crf_n_landmarks`, so the
reference computes the filter the program computes; the exact function
is put back after, also when the run raises.  A traced run adds kernel
4's least time a step (harness/landmark_bound.py) as ctx["knm"]."""
from __future__ import annotations

import functools

from benchmark.harness import landmark_bound
from benchmark.harness.runners import train
from benchmark.reference import losses, nystrom


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, work: str, **kw) -> dict:
    flags = cell["config"]["flags"]
    if flags.get("crf_impl") != "landmarks":
        raise ValueError(f"{cell['entry']['name']}: crf_impl "
                         f"{flags.get('crf_impl')!r} is not 'landmarks'")
    m = int(flags["crf_n_landmarks"])
    exact = losses.crf
    losses.crf = functools.partial(nystrom.crf, n_landmarks=m)
    try:
        ctx = train.run(cell, seed, seconds, trace, device, t_start, work,
                        **kw)
    finally:
        losses.crf = exact
    if trace:
        crop = int(flags["crop_size"])
        ctx["knm"] = landmark_bound.knm_bound(int(flags["batch_size"]),
                                              crop * crop, m)
    return ctx
