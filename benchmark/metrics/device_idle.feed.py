"""The traced epoch's share of wall time with no kernel, copy or
fill on the device, in %."""
from benchmark.metrics._records import idle as read  # noqa: F401
