"""PyTorch/CUDA port of tcam_wsol_video_tpu for NVIDIA Hopper (H100).

The subpackages mirror the JAX package's layout and module names; each
port module sits at the same relative path as its counterpart.  Public
functions keep the JAX layouts (NHWC images, (B, H, W, 2) fcams) so the
two packages can be held against each other on the same inputs.  Entry
points take an explicit `device` and default to CUDA.
"""
