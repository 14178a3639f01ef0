"""Port parity of the CPU bilateral grid (ops/native.py): the port's
ctypes binding of native/bilateral_grid.cpp, built with the JAX package's
g++ flags into the port's build/native/, against the JAX package's
binding of the same C++ on the same inputs: bit-equal."""
import numpy as np
import pytest

from tcam_wsol_video_tpu.ops.native import \
    bilateral_filter_batch_native as jfilter
from tcam_wsol_video_tpu_torch.core import nativebuild
from tcam_wsol_video_tpu_torch.ops.native import \
    bilateral_filter_batch_native


@pytest.mark.parametrize("sigma_xy", [None, 100.0, 5.0])
def test_bilateral_grid_bit_equal(sigma_xy):
    rng = np.random.default_rng(0)
    img = (rng.random((2, 24, 20, 3)) * 255).astype(np.float32)
    segs = rng.random((2, 24, 20, 3)).astype(np.float32)
    got = bilateral_filter_batch_native(img, segs, 15.0, sigma_xy)
    want = jfilter(img, segs, 15.0, sigma_xy)
    assert got.dtype == np.float32 and got.shape == segs.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_built_into_the_ports_build_dir():
    bilateral_filter_batch_native(np.zeros((1, 4, 4, 3), np.float32),
                                  np.ones((1, 4, 4, 2), np.float32), 15.0,
                                  None)
    lib = nativebuild.library("bilateral_grid")
    assert lib.startswith(nativebuild.BUILD_DIR)
    assert nativebuild.LIBS["bilateral_grid"][0].endswith(
        "native/bilateral_grid.cpp")
