"""Seconds of the program's build before its first epoch: the spans
setup.data (cli/train.build_data), setup.model
(models/factory.create_model_from_args), setup.trainer (Trainer.__init__)
and setup.kernels (a kernel or host library's first load) closed
before it."""
from benchmark.metrics._spans import setup_ms

BUILD = ("setup.data", "setup.model", "setup.trainer", "setup.kernels")


def read(ctx):
    ms = setup_ms(ctx, BUILD)
    return None if ms is None else ms * 1e-3
