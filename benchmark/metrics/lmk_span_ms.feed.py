"""The host ms an epoch inside the program's span crf.landmarks (the
landmark filter enqueued: at each graph capture on the chunked route, at
every step on the eager route), averaged over the window's epochs; None
where no record holds the span."""
from benchmark.metrics._spans import per_epoch


def read(ctx):
    return per_epoch(ctx, "crf.landmarks")
