"""The median over the window's steps of the step's device span (the
trainer's step_ms: CUDA events around a step, or a graph replay over its
K steps)."""
from benchmark.metrics._records import median_step_ms as read  # noqa: F401
