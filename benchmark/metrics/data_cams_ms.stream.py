"""The host CAM side of a streamed batch (the pipeline's
data_cams_ms_per_step: CAM fusion, resize, crop, ROI), averaged over the
window's steps."""
from benchmark.metrics._records import step_weighted


def read(ctx):
    return step_weighted(ctx, "data_cams_ms_per_step")
