"""Frames trained over the window (every epoch of it) over its
seconds."""
from benchmark.metrics._records import frames_per_s as read  # noqa: F401
