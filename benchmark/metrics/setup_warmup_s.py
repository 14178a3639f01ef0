"""Seconds of the trainer's first epoch (the warm-up: the first decodes,
kernel loads and graph captures), its span `epoch`."""
from benchmark.metrics._spans import setup_ms


def read(ctx):
    ms = setup_ms(ctx, ("epoch",))
    return None if ms is None else ms * 1e-3
