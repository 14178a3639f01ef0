"""The window's steps' model FLOPs (with the exact CRF filter's least
operations) over its seconds, as a share of the H100's dense bf16 peak
(harness/flops.py), in %."""
from benchmark.metrics._records import mfu as read  # noqa: F401
