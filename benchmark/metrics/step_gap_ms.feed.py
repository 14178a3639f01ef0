"""The device's time between consecutive steps (a chunk's replays on the
chunked route), from the CUDA events around them (device.gap), summed
over the window's epochs and divided by their steps."""
from benchmark.metrics._spans import per_step


def read(ctx):
    return per_step(ctx, "device.gap")
