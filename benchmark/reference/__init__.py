"""The plain reference: fp32 PyTorch and NumPy, written for the benchmark.

It imports nothing of the measured program (tcam_wsol_video_tpu_torch) and
nothing of the JAX package: tests/test_bench_isolation.py walks its imports.
Where its arithmetic follows the JAX package's recipe (the seeder's
bisection, the box and CAM geometry, the sampling streams), it is a frozen
copy, so a later change to the program is held to the recipe as it stands
here."""
