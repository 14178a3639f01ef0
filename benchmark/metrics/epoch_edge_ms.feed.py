"""The self ms of the span `epoch` (what none of its child spans covers:
the epoch's set-up of its graphs' inputs, the record, the ELB anneal),
averaged over the window's epochs."""
from benchmark.metrics._spans import SELF_MS, per_epoch


def read(ctx):
    return per_epoch(ctx, "epoch", SELF_MS)
