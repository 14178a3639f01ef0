"""The benchmark's general code: the manifest, the set, the weights, the
runners, the tap, the checks, the trace and the result."""
