"""The CUDA bilateral kernel against its plain version, on the card.

Marked `cuda`: without a GPU these tests skip (the decision is taken in a
fixture, never at import).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import pytest
import torch

from tcam_wsol_video_tpu_torch.ops import crf
from tcam_wsol_video_tpu_torch.ops.cuda import bilateral

pytestmark = pytest.mark.cuda

# ex2.approx and the fp32 norm expansion against the plain version's
# fp32 matmul, relative to the largest output (see chip_smoke.py)
RTOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,w,sigma_xy,k", [
    (2, 64, 64, 100.0, 2), (3, 37, 53, 100.0, 2), (2, 40, 40, None, 2),
    (1, 29, 31, 100.0, 5)])
def test_kernel_matches_plain(card, b, h, w, sigma_xy, k):
    g = torch.Generator(device=card).manual_seed(0)
    img = torch.rand((b, h, w, 3), generator=g, device=card) * 255.0
    feats = crf.make_bilateral_features(img, 15.0, sigma_xy).contiguous()
    vals = torch.rand((b, h * w, k), generator=g, device=card)
    before = bilateral.counts.kernel
    got = bilateral.gaussian_filter_apply_batched(feats, vals)
    torch.cuda.synchronize()
    assert bilateral.counts.kernel == before + 1
    want = bilateral.gaussian_filter_apply_plain(feats, vals)
    assert (got - want).abs().max() <= RTOL * want.abs().max()
