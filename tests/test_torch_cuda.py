"""The CUDA kernels (exact bilateral filter, landmark K_nm build, the two
Nystrom passes) against their plain versions, on the card.

Marked `cuda`: without a GPU these tests skip (the decision is taken in a
fixture, never at import).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import pytest
import torch

from tcam_wsol_video_tpu_torch.ops import crf
from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, landmarks

pytestmark = pytest.mark.cuda

# ex2.approx and the fp32 norm expansion against the plain version's
# fp32 matmul, relative to the largest output (see chip_smoke.py)
RTOL = 2e-4
# K entries in [0, 1]: fp32 cancellation of the norm expansion (atol), and
# one bf16 step at [0.5, 1) where the two round on either side of a tie
KNM_ATOL = 1e-4
KNM_BF16_ATOL = 4e-3
# the Nystrom filter: the ridge solve (K_mm + 1e-2 I) passes the weights'
# fp32 differences on, relative to the largest output
LMK_RTOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _filter_inputs(card, b, h, w, sigma_xy, k):
    g = torch.Generator(device=card).manual_seed(0)
    img = torch.rand((b, h, w, 3), generator=g, device=card) * 255.0
    feats = crf.make_bilateral_features(img, 15.0, sigma_xy).contiguous()
    vals = torch.rand((b, h * w, k), generator=g, device=card)
    return feats, vals


# the kernel tiles pixels by bilateral.TILE = 256: P below one tile, one
# tile exactly, odd (3, 13) and even (4, 16, 36) tile counts, and B = 1 over
# many tiles (its strips split over several blocks)
@pytest.mark.parametrize("b,h,w,sigma_xy,k", [
    (2, 64, 64, 100.0, 2), (3, 37, 53, 100.0, 2), (2, 40, 40, None, 2),
    (1, 29, 31, 100.0, 5), (2, 9, 13, 100.0, 2), (2, 16, 16, 100.0, 2),
    (2, 25, 28, 100.0, 2), (2, 30, 30, None, 2), (1, 96, 96, 100.0, 2),
    (1, 56, 56, 100.0, 5)],
    ids=["64x64", "ragged_37x53", "color_only", "K5", "P117_below_tile",
         "P256_one_tile", "odd_3_tiles", "even_4_tiles", "B1_36_tiles",
         "B1_13_tiles_K5"])
def test_kernel_matches_plain(card, b, h, w, sigma_xy, k):
    feats, vals = _filter_inputs(card, b, h, w, sigma_xy, k)
    before = bilateral.counts.kernel
    got = bilateral.gaussian_filter_apply_batched(feats, vals)
    torch.cuda.synchronize()
    assert bilateral.counts.kernel == before + 1
    want = bilateral.gaussian_filter_apply_plain(feats, vals)
    assert (got - want).abs().max() <= RTOL * want.abs().max()


@pytest.mark.parametrize("d,k", [(8, 2), (7, 8)])
def test_kernel_wide_instances_match_plain(card, d, k):
    g = torch.Generator(device=card).manual_seed(2)
    feats = torch.randn((2, 700, d), generator=g, device=card) * 1.5
    vals = torch.rand((2, 700, k), generator=g, device=card)
    got = bilateral.gaussian_filter_apply_batched(feats, vals)
    want = bilateral.gaussian_filter_apply_plain(feats, vals)
    assert (got - want).abs().max() <= RTOL * want.abs().max()


@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (1, 96, 96)])
def test_kernel_is_deterministic(card, b, h, w):
    feats, vals = _filter_inputs(card, b, h, w, 100.0, 2)
    first = bilateral.gaussian_filter_apply_batched(feats, vals)
    second = bilateral.gaussian_filter_apply_batched(feats, vals)
    assert torch.equal(first, second)


def test_kernel_chunks_the_batch_under_the_scratch_cap(card, monkeypatch):
    feats, vals = _filter_inputs(card, 3, 37, 53, 100.0, 2)
    whole = bilateral.gaussian_filter_apply_batched(feats, vals)
    monkeypatch.setattr(bilateral, "SCRATCH_CAP", 1)
    assert len(bilateral.plan(3, 37 * 53, 2, 132, cap=1)) == 3
    chunked = bilateral.gaussian_filter_apply_batched(feats, vals)
    assert (chunked - whole).abs().max() <= RTOL * whole.abs().max()


def _landmark_inputs(card, b, h, w, sigma_xy, m_req, k=2):
    g = torch.Generator(device=card).manual_seed(1)
    img = torch.rand((b, h, w, 3), generator=g, device=card) * 255.0
    feats = crf.make_bilateral_features(img, 15.0, sigma_xy)
    feats = (feats - feats.mean(1, keepdim=True)).contiguous()
    idx = torch.from_numpy(crf._landmark_grid_indices(h, w, m_req)).to(card)
    vals = torch.rand((b, h * w, k), generator=g, device=card)
    return feats, feats[:, idx].contiguous(), idx, vals


@pytest.mark.parametrize("b,h,w,sigma_xy,m_req", [
    (2, 64, 64, 100.0, 512), (3, 37, 53, 100.0, 512), (2, 24, 48, None, 256)])
def test_build_knm_matches_plain(card, b, h, w, sigma_xy, m_req):
    feats, fm, _, _ = _landmark_inputs(card, b, h, w, sigma_xy, m_req)
    before = landmarks.knm_counts.kernel
    got = landmarks.build_knm(feats, fm)
    got16 = landmarks.build_knm(feats, fm, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert landmarks.knm_counts.kernel == before + 2
    want = landmarks.build_knm_plain(feats, fm)
    assert (got - want).abs().max() <= KNM_ATOL
    assert (got16.float() - want).abs().max() <= KNM_BF16_ATOL


@pytest.mark.parametrize("b,h,w,sigma_xy,m_req,k", [
    (2, 64, 64, 100.0, 512, 2), (3, 37, 53, 100.0, 512, 2),
    (2, 24, 48, None, 256, 2), (1, 29, 31, 100.0, 128, 5)])
def test_nystrom_filter_matches_plain(card, b, h, w, sigma_xy, m_req, k):
    feats, fm, idx, vals = _landmark_inputs(card, b, h, w, sigma_xy, m_req,
                                            k)
    before = (landmarks.rhs_counts.kernel, landmarks.out_counts.kernel)
    rhs = landmarks.nystrom_rhs(feats, fm, vals)
    got = landmarks.nystrom_filter(feats, vals, idx)
    built = crf.gaussian_filter_apply_landmarks(feats, vals, idx,
                                                fused=False)
    torch.cuda.synchronize()
    assert (landmarks.rhs_counts.kernel, landmarks.out_counts.kernel) == (
        before[0] + 2, before[1] + 1)
    want_rhs = landmarks.nystrom_rhs_plain(feats, fm, vals)
    assert (rhs - want_rhs).abs().max() <= RTOL * want_rhs.abs().max()
    want = landmarks.nystrom_filter_plain(feats, vals, idx)
    for out in (got, built):
        assert (out - want).abs().max() <= LMK_RTOL * want.abs().max()


# a baseline JPEG at quality 95 with 4:2:0 chroma against its source
# frame (noise in [0, 60) and a saturated square): mean |difference| in
# levels (see chip_smoke.py)
JPEG_MEAN_ABS_TOL = 12.0


def test_nvjpeg_round_trip_and_card_route(card, tmp_path):
    """nvJPEG encode + decode against the source frames, and the card
    route's batch (decode, resize, crop, flip, normalize on the card)
    against the same arithmetic on the CPU from the card's decoded
    frames."""
    import numpy as np
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.synthetic import write_jpeg
    rng = np.random.default_rng(0)
    paths, frames = [], []
    for i in range(4):
        img = (rng.random((90, 120, 3)) * 60).astype(np.uint8)
        img[20:50, 30 + i:70 + i] = (220, 40, 40)
        path = str(tmp_path / f"f{i}.jpg")
        write_jpeg(path, img, card)
        dec = nvjpeg_loader.decode(path, card)
        assert dec.shape == (90, 120, 3) and dec.dtype == torch.uint8
        assert np.abs(dec.cpu().numpy().astype(float) - img).mean() <= \
            JPEG_MEAN_ABS_TOL
        paths.append(path)
        frames.append(dec.cpu())
    xs, ys, flips = [0, 3, 8, 1], [8, 0, 2, 7], [0, 1, 0, 1]
    norm, raw = nvjpeg_loader.load_batch(paths, 40, 32, xs, ys, flips, card)
    want_n, want_r = nvjpeg_loader.resize_crop_normalize(
        torch.stack(frames), 40, 32, xs, ys, flips)
    assert torch.allclose(raw.cpu(), want_r, atol=1e-4, rtol=0)
    assert torch.allclose(norm.cpu(), want_n, atol=1e-5, rtol=0)
