"""The host's wait for each batch on the card-resident feed route
(the trainer's data_wait_ms_per_step), averaged over the window's steps."""
from benchmark.metrics._records import step_weighted


def read(ctx):
    return step_weighted(ctx, "data_wait_ms_per_step")
