"""The host's time to enqueue a step (a chunk's over its steps on the
chunked route: the trainer's host_enqueue_ms_per_step), averaged over the
window's steps."""
from benchmark.metrics._records import step_weighted


def read(ctx):
    return step_weighted(ctx, "host_enqueue_ms_per_step")
