"""The benchmark of the PyTorch/CUDA port (tcam_wsol_video_tpu_torch).

run.py is the entry point; BENCHMARK.json at the repository root lists the
cells.  See README.md."""
