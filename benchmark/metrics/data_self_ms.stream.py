"""The self ms of the host's wait for a streamed batch (data.wait less
data.pixels and data.cams: the sampling, augment draws, collate and the
pinned copy), over the window's steps."""
from benchmark.metrics._spans import SELF_MS, per_step


def read(ctx):
    return per_step(ctx, "data.wait", SELF_MS)
