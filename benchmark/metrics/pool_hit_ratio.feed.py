"""The share of the frames the window's epochs sampled that the
card-resident feed's pool already held: 100 x (1 - feed.misses /
feed.frames), in %."""
from benchmark.metrics._spans import counted


def read(ctx):
    frames = counted(ctx, "feed.frames")
    if not frames:
        return None
    return 100.0 * (1.0 - (counted(ctx, "feed.misses") or 0) / frames)
