"""The host's pixel work of a streamed batch (the span data.pixels:
decode, resize, crop; on the card nvJPEG's host phase), over the
window's steps."""
from benchmark.metrics._spans import per_step


def read(ctx):
    return per_step(ctx, "data.pixels")
