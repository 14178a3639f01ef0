"""The host's wait for each streamed batch (the trainer's
data_wait_ms_per_step: decode, resize, crop, the CAM side), averaged over
the window's steps."""
from benchmark.metrics._records import step_weighted


def read(ctx):
    return step_weighted(ctx, "data_wait_ms_per_step")
