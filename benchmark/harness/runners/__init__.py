"""One runner per traffic `kind`: run(cell, seed, seconds, trace, device,
t_start, work, calibrate=False) -> the context the readers read."""
