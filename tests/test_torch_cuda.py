"""The CUDA kernels (exact bilateral filter, landmark K_nm build, the two
Nystrom passes) against their plain versions, and the card's routes of
the steps and the data plane against the CPU's or the host's, on the card.

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


def test_pil_resize_on_the_card_bit_equal_to_cpu(card, tmp_path):
    """The dump's resize (Pillow's BILINEAR as integer passes) on the
    card against the same function on the CPU, for the same decoded
    frames, whole and through the card's route (nvJPEG + resize)."""
    import numpy as np
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.synthetic import write_jpeg
    from tcam_wsol_video_tpu_torch.data.transforms import \
        pil_bilinear_resize
    rng = np.random.default_rng(1)
    paths = []
    for i in range(3):
        img = (rng.random((270, 360, 3)) * 200).astype(np.uint8)
        img[50:150, 40 + 9 * i:210] = (30, 200, 90)
        paths.append(str(tmp_path / f"f{i}.jpg"))
        write_jpeg(paths[-1], img, card)
    frames = torch.stack([nvjpeg_loader.decode(p, card) for p in paths])
    for size in ((224, 224), (32, 32)):
        want = pil_bilinear_resize(frames.cpu(), size)
        assert torch.equal(pil_bilinear_resize(frames, size).cpu(), want)
        assert torch.equal(
            nvjpeg_loader.load_resized_u8(paths, size, card).cpu(), want)


# TF32 convolutions (cuDNN's default) against the CPU's fp32: logits
# relative to the largest (path A's TF32 bound, chip_smoke.py); CAMs are
# min-max normalized maps in [0, 1], absolute
TF32_RTOL = 1e-2
CAM_TF32_ATOL = 2e-2


def test_std_cl_eval_step_on_the_card_matches_cpu(card):
    import copy
    from tcam_wsol_video_tpu_torch.core.config import stage1_cam_recipe
    from tcam_wsol_video_tpu_torch.engine.steps import make_cam_eval_step
    from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
    from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
    torch.manual_seed(0)
    model = STDClassifier(ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10)
    args = stage1_cam_recipe(crop_size=64)
    x = torch.randn(4, 64, 64, 3)
    labels = torch.tensor([0, 3, 9, 3])
    cams, logits = make_cam_eval_step(model, args)(x, targets=labels)
    gpu = copy.deepcopy(model).to(card)
    cams_c, logits_c = make_cam_eval_step(gpu, args)(
        x.to(card), targets=labels.to(card))
    assert cams_c.shape == cams.shape == (4, 64, 64)
    assert (cams_c.cpu() - cams).abs().max() <= CAM_TF32_ATOL
    assert (logits_c.cpu() - logits).abs().max() <= \
        TF32_RTOL * logits.abs().max()


def _tcam_step(card, model):
    """One stage-2 train step of `model` at the recipe's compute dtype
    (bfloat16), batch 2 at 64 px, as a callable returning its metrics."""
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import stage2_tcam_recipe
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    args = stage2_tcam_recipe(crop_size=64, batch_size=2)
    assert args.compute_dtype == "bfloat16"
    state = TrainState(model, build_optimizer(args, model, args.lr),
                       args.elb_init_t)
    master = get_loss_tcam(args)
    g = torch.Generator(device=card).manual_seed(0)
    batch = {"image": torch.randn((2, 64, 64, 3), generator=g, device=card),
             "raw_img": torch.rand((2, 64, 64, 3), generator=g,
                                   device=card) * 255.0,
             "label": torch.tensor([1, 4], device=card),
             "std_cam": torch.rand((2, 64, 64), generator=g, device=card),
             "roi": torch.ones((2, 64, 64), dtype=torch.int32, device=card)}
    run = make_train_step(master, args, seeder_cfg_from_args(args))
    return lambda: run(state, batch, master.switches(0), True,
                       generator=torch.Generator(device=card).manual_seed(1))


def test_bf16_tcam_step_on_the_card(card, monkeypatch):
    """One stage-2 step at the default compute dtype (bfloat16) on the
    card: every convolution hands cuDNN bf16 inputs and weights, the
    exact CRF kernel (fp32 inputs, as JAX casts them) launches once, no
    plain version runs, and the parameters and their gradients stay
    fp32."""
    from tcam_wsol_video_tpu_torch.models import resnet
    from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
    torch.manual_seed(0)
    model = UnetTCAM(resnet.ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10,
                     freeze_cl=True).to(card)
    step = _tcam_step(card, model)
    seen = set()
    conv = resnet.Conv2d._conv_forward

    def spy(self, x, weight, bias):
        seen.add((x.dtype, weight.dtype, weight.device.type))
        return conv(self, x, weight, bias)

    monkeypatch.setattr(resnet.Conv2d, "_conv_forward", spy)
    counters = (bilateral.counts, landmarks.knm_counts, landmarks.rhs_counts,
                landmarks.out_counts)
    for c in counters:
        c.reset()
    met = step()
    torch.cuda.synchronize()
    assert seen == {(torch.bfloat16, torch.bfloat16, "cuda")}
    assert bilateral.counts.kernel == 1
    assert all(c.plain == 0 for c in counters)
    assert all(bool(torch.isfinite(v).all()) for v in met.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)


def test_tcam_decoder_runs_channels_last_on_the_card(card, tmp_path):
    """One bf16 train step of UnetTCAM on ResNet-50 (freeze_cl), traced:
    every BatchNorm kernel is torch's channels-last one and cuDNN runs no
    NCHW <-> NHWC transpose, so the decoder stays channels-last from the
    encoder's features to fcams (models/unet.py)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from tcam_wsol_video_tpu_torch.models.factory import create_model
    torch.manual_seed(0)
    model = create_model("TCAM", "resnet50", 10, "WGAP", freeze_cl=True,
                         device=card)
    step = _tcam_step(card, model)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    # a kernel's own name, without its template arguments (an elementwise
    # kernel of the running-statistics update names batch_norm in them)
    names = {k.split("<")[0].lower() for k in kernels}
    bn = {k for k in names if "batch_norm" in k}
    assert any("bilateral" in k for k in names)
    assert bn and all("channels_last" in k for k in bn), sorted(bn)
    assert not [k for k in names if "nchwtonhwc" in k or "nhwctonchw" in k]


def _cbox_args(**kw):
    from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
    return TCAMConfig(task="C_BOX", arch="DenseBoxNet", crop_size=64,
                      batch_size=2, cb_area_box=True, cb_cl_score=True,
                      cb_seed=True, cb_pp_box=True, cb_seed_n=4,
                      cb_cl_score_blur_ksize=17, cb_cl_score_blur_sigma=8.0,
                      **kw)


def _cbox_models(card=None):
    """A small DenseBoxNet whose box head predicts (6, 8, 50, 44) on
    average, and a frozen STDClassifier, from seed 0."""
    from tcam_wsol_video_tpu_torch.models.classifier import (DenseBoxNet,
                                                             STDClassifier)
    from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
    torch.manual_seed(0)
    box = DenseBoxNet(ResNetWSOL(layers=(1, 1, 1, 1)))
    with torch.no_grad():
        box.box_head.weight.mul_(0.1)
        box.box_head.bias.copy_(torch.tensor([6.0, 8.0, 50.0, 44.0]))
    cls = STDClassifier(ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10)
    cls.requires_grad_(False)
    if card is not None:
        box, cls = box.to(card), cls.to(card)
    return box, cls


def test_bf16_cbox_step_on_the_card(card, monkeypatch):
    """One C_BOX step at the default compute dtype (bfloat16) on the card:
    both models hand cuDNN bf16 convolutions, no CRF kernel or plain
    version runs, the metrics are finite, the frozen classifier takes no
    gradient and the box model's parameters and gradients stay fp32."""
    from tcam_wsol_video_tpu_torch.cams.seeding import \
        cbox_seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.engine.cbox_steps import \
        make_cbox_train_step
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.losses.build import get_loss
    from tcam_wsol_video_tpu_torch.models import resnet
    args = _cbox_args()
    assert args.compute_dtype == "bfloat16"
    model, cls = _cbox_models(card)
    state = TrainState(model, build_optimizer(args, model, args.lr))
    master = get_loss(args)
    g = torch.Generator(device=card).manual_seed(0)
    batch = {"image": torch.randn((2, 64, 64, 3), generator=g, device=card),
             "label": torch.tensor([1, 4], device=card),
             "std_cam": torch.rand((2, 64, 64), generator=g, device=card)}
    seen = set()
    conv = resnet.Conv2d._conv_forward

    def spy(self, x, weight, bias):
        seen.add((x.dtype, weight.dtype, weight.device.type))
        return conv(self, x, weight, bias)

    monkeypatch.setattr(resnet.Conv2d, "_conv_forward", spy)
    counters = (bilateral.counts, landmarks.knm_counts, landmarks.rhs_counts,
                landmarks.out_counts)
    for c in counters:
        c.reset()
    met = make_cbox_train_step(
        master, args, cbox_seeder_cfg_from_args(args), cls,
        size_priors_min_s=[0.05] * 10)(
        state, batch, master.switches(0),
        generator=torch.Generator(device=card).manual_seed(1))
    torch.cuda.synchronize()
    assert seen == {(torch.bfloat16, torch.bfloat16, "cuda")}
    assert all(c.kernel == 0 and c.plain == 0 for c in counters)
    assert set(met) >= {"area_box", "cl_scoring", "seed_cbox", "box_bounds"}
    assert all(bool(torch.isfinite(v).all()) for v in met.values())
    assert int(met["valid_boxes"]) == 2
    assert all(p.grad is None for p in cls.parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


def test_cbox_eval_step_on_the_card_matches_cpu(card):
    """The C_BOX eval step at fp32 on the card (TF32 convolutions) against
    the CPU: boxes within TF32's bound of the image size, the same
    validity, logits within TF32's bound."""
    import copy
    from tcam_wsol_video_tpu_torch.engine.cbox_steps import \
        make_cbox_eval_step
    args = _cbox_args(compute_dtype="float32")
    model, cls = _cbox_models()
    x = torch.randn(4, 64, 64, 3)
    boxes, valid, logits = make_cbox_eval_step(model, cls, args)(x)
    boxes_c, valid_c, logits_c = make_cbox_eval_step(
        copy.deepcopy(model).to(card), copy.deepcopy(cls).to(card),
        args)(x.to(card))
    assert (boxes_c.cpu() - boxes).abs().max() <= TF32_RTOL * 64
    assert torch.equal(valid_c.cpu(), valid) and int(valid.sum()) == 4
    assert (logits_c.cpu() - logits).abs().max() <= \
        TF32_RTOL * logits.abs().max()


def test_cbox_seeder_on_the_card_matches_cpu(card):
    """cbox_seeder on the card from the CPU's noise: the same masks
    (STOtsu's integer histograms, the sort, max-pool morphology)."""
    from tcam_wsol_video_tpu_torch.cams.seeding import (CBoxSeederCfg,
                                                        cbox_seeder,
                                                        gumbel_noise)
    g = torch.Generator().manual_seed(3)
    yy, xx = torch.meshgrid(torch.arange(56.0), torch.arange(56.0),
                            indexing="ij")
    centres = 14 + 28 * torch.rand((6, 2), generator=g)
    cams = torch.exp(-((yy - centres[:, :1, None]) ** 2
                       + (xx - centres[:, 1:, None]) ** 2) / 200.0)
    cams = 0.9 * cams + 0.1 * torch.rand((6, 56, 56), generator=g)
    cams[-1] = 0.5
    gumbel = gumbel_noise((6, 2, 56 * 56), g, "cpu")
    z = 0.3 + 0.1 * torch.rand((6,), generator=g)
    cfg = CBoxSeederCfg(n=10)
    want = cbox_seeder(cams, cfg, gumbel=gumbel, z=z)
    got = cbox_seeder(cams.to(card), cfg, gumbel=gumbel.to(card),
                      z=z.to(card))
    assert torch.equal(got.cpu(), want)
    assert (want == 1).any() and (want == 0).any()


def test_card_decode_cache_and_u8_route(card, tmp_path):
    """decode_resize_u8 on the card: fastloader's resize rounded half up,
    against the same arithmetic on the CPU from the card's decoded frames;
    the card's decoded-frame cache serves the same pixels as its frames
    cropped on the CPU, with its hits and misses."""
    import numpy as np
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    from tcam_wsol_video_tpu_torch.data.synthetic import write_jpeg
    rng = np.random.default_rng(1)
    paths = []
    for i in range(5):
        img = (rng.random((90, 120, 3)) * 255).astype(np.uint8)
        paths.append(str(tmp_path / f"f{i}.jpg"))
        write_jpeg(paths[-1], img, card)
    frames = torch.stack([nvjpeg_loader.decode(p, card).cpu()
                          for p in paths])
    want = (nvjpeg_loader.resize_fastloader(frames, 40) + 0.5).clamp(
        max=255.0).to(torch.uint8)
    got = nvjpeg_loader.decode_resize_u8(paths, 40, card)
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    cache = nvjpeg_loader.DeviceFrameCache(1, card)
    batch = paths[:3] + paths[:1]
    xs, ys, flips = [0, 3, 8, 1], [8, 0, 2, 7], [0, 1, 0, 1]
    norm, raw = cache.load_batch(batch, 40, 32, xs, ys, flips)
    assert (cache.hits, cache.misses) == (0, 4)
    want_n, want_r = nvjpeg_loader.crop_normalize_u8(
        want[[0, 1, 2, 0]], 32, xs, ys, flips)
    # the card divides by 255 as a product with its reciprocal: an ulp
    assert torch.equal(raw.cpu(), want_r)
    assert torch.allclose(norm.cpu(), want_n, atol=1e-5, rtol=0)
    cache.load_batch(batch, 40, 32, xs, ys, flips)
    assert (cache.hits, cache.misses) == (4, 4)


def test_roi_and_compact_batches_on_the_card(card):
    """roi_batch for every method on the card against the same function
    on the CPU, and compact_batch / expand_compact_batch through a card
    round trip bit-equal to the CPU's."""
    import numpy as np
    from tcam_wsol_video_tpu_torch.cams.roi import roi_batch
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.data.pipeline import compact_batch
    from tcam_wsol_video_tpu_torch.engine.steps import expand_compact_batch
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    cams = np.zeros((8, 64, 64), np.float32)
    for i in range(8):
        for _ in range(3):
            cy, cx = rng.uniform(8, 56, 2)
            cams[i] = np.maximum(cams[i], rng.uniform(0.3, 1.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0))
    cpu = torch.from_numpy(cams)
    for method in constants.ROI_SELECT:
        want = roi_batch(cpu, method)
        got = roi_batch(cpu.to(card), method)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), method
    batch = {"raw_img": torch.from_numpy(rng.uniform(
        0, 255, (4, 32, 32, 3)).astype(np.float32)),
        "std_cam": cpu[:4, :32, :32], "roi": (cpu[:4, :32, :32] > 0.5).int(),
        "msk_bbox": torch.ones(4, 32, 32)}
    want = expand_compact_batch(compact_batch(batch))
    got = expand_compact_batch({k: v.to(card) for k, v in compact_batch(
        {k: v.to(card) if k == "raw_img" else v
         for k, v in batch.items()}).items()})
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


# the streamed route's card CAM side against its host route
# (tests/test_torch_dataplane.py's feed-against-stream tolerances)
STREAM_CAM_ATOL = 2e-4
STREAM_ROI_AGREE = 0.995
STREAM_FG_ATOL = 2e-3


def _stream_set(root: str, card):
    """The port's synthetic set (48 train frames of 90 x 120, written by
    nvJPEG) and a store of one 14 x 14 CAM of 1-3 Gaussian blobs a train
    frame, with a stored threshold for each."""
    import os
    import numpy as np
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
    from tcam_wsol_video_tpu_torch.data.folds import load_split_metadata
    from tcam_wsol_video_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    out = make_synthetic_dataset(root, device=card)
    store = CamStore(os.path.join(root, "cams"))
    md = load_split_metadata(out["metadata_root"], constants.TRAINSET)
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:14, 0:14].astype(np.float32)
    th = {}
    for shot in md.image_ids:
        for f in sorted(os.listdir(os.path.join(out["data_root"], shot))):
            cam = np.zeros((14, 14), np.float32)
            for _ in range(rng.integers(1, 4)):
                cy, cx = rng.uniform(1, 13, 2)
                s = rng.uniform(0.8, 3.0)
                cam = np.maximum(cam, rng.uniform(0.4, 1.0) * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
            store.save_cam(f"{shot}/{f}", cam)
            th[f"{shot}/{f}"] = float(rng.uniform(0.2, 0.5))
    store.save_thresholds(th)
    return out, md, store


@pytest.mark.parametrize("compact", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("knn", [0, 1])
def test_streamed_cam_planes_on_the_card(card, tmp_path, monkeypatch, knn,
                                         compact):
    """A CUDA DataPipeline over a CAM store makes every batch's CAM planes
    on the card (data.cams_card counts each frame) and streams the keys
    and dtypes of its host route (the same pipeline with the card route
    refused), with the same ids and pixels and the CAM planes within the
    feed-against-stream tolerances.  knn 1 heats its windows; under
    h2d_transfer=uint8 the host planes cross packed, the card's stay
    unpacked, so the batches are compared as the step expands them."""
    from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.core.clock import TRACE
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.data import pipeline
    from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
    from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
    from tcam_wsol_video_tpu_torch.engine.steps import expand_compact_batch
    out, md, store = _stream_set(str(tmp_path), card)
    mode = constants.TIME_BEFORE_AFTER if knn else constants.TIME_INSTANT
    decay = (DecayTemp(sl_tc_knn_t=4.0, sl_tc_min_t=1.0, sl_tc_knn=knn,
                       sl_tc_knn_mode=mode, sl_tc_knn_epoch_switch_uniform=-1,
                       sl_tc_seed_tech=constants.SEED_WEIGHTED)
             if knn else None)
    ds = WSOLVideoDataset(md, out["data_root"], constants.TRAINSET,
                          constants.YTOV1, PairedTransform(40, 32, train=True),
                          KeyChain(7), crop_size=32, cam_store=store,
                          sl_tc_knn=knn, sl_tc_knn_mode=mode,
                          decay_temp=decay, use_roi=True,
                          roi_method=constants.ROI_LARGEST)

    def epoch():
        pipe = pipeline.DataPipeline(ds, 5, KeyChain(7), compact=compact,
                                     device=card)
        TRACE.take()
        batches = [expand_compact_batch(b) for b in pipe.epoch(1)]
        return batches, TRACE.take()[1]

    card_batches, card_counts = epoch()
    monkeypatch.setattr(pipeline, "card_cam_planes", lambda *a: None)
    host_batches, host_counts = epoch()
    assert card_counts.get("data.cams_card") == len(ds) == 12
    assert "data.cams_host" not in card_counts
    assert host_counts.get("data.cams_host") == len(ds)
    assert "data.cams_card" not in host_counts
    assert len(card_batches) == len(host_batches) == 3
    for got, want in zip(card_batches, host_batches):
        assert got["image_id"] == want["image_id"]
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "image_id":
                continue
            g = got[k]
            assert g.device.type == "cuda" and g.dtype == w.dtype, k
            assert g.shape == w.shape, k
            if k not in ("std_cam", "roi", "msk_bbox", "fg_size"):
                assert torch.equal(g, w), k
        assert (got["std_cam"] - want["std_cam"]).abs().max() <= \
            STREAM_CAM_ATOL
        agree = (got["roi"] == want["roi"]).float().mean().item()
        assert agree >= STREAM_ROI_AGREE, agree
        assert (got["fg_size"] - want["fg_size"]).abs().max() <= \
            STREAM_FG_ATOL
        assert (got["has_cam"] == 1.0).all()
    # 12 frames in batches of 5: the last one padded by tiling
    assert sum(int(b["valid"].sum()) for b in card_batches) == len(ds)


# the lockstep solve against cholesky_ex on ridge-regularized kernel
# systems, relative L2 (tests/test_torch_landmarks.py's SOLVE_RTOL)
SOLVE_RTOL = 5e-4


@pytest.mark.parametrize("g,m", [(4, 1024), (3, 300)])
def test_lockstep_solve_on_the_card_matches_cholesky(card, g, m):
    from tcam_wsol_video_tpu_torch.ops import linalg
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((g, m, 5), generator=gen, device=card)
    a = landmarks.add_ridge(landmarks.build_knm_plain(x, x), 1e-2)
    b = torch.randn((g, m, 2), generator=gen, device=card)
    with linalg.record_info() as infos:
        want = linalg.batched_cholesky_solve(a, b)
    got = linalg.lockstep_solve(a, b)
    torch.cuda.synchronize()
    assert all(int(i.abs().max()) == 0 for i in infos)
    assert float((got - want).norm() / want.norm()) < SOLVE_RTOL
    cpu = linalg.lockstep_solve(a.cpu(), b.cpu())
    assert float((got.cpu() - cpu).norm() / cpu.norm()) < SOLVE_RTOL


# an F_CL step's loss terms through kernel 1 against the same step with
# the plain filter: the CRF term carries the filter's relative error
STEP_RTOL = 2e-4


def test_f_cl_step_through_the_exact_kernel_matches_plain(card,
                                                          monkeypatch):
    """One F_CL step at float32 (every F-CAM loss and im_rec, the exact
    CRF) on the card launches kernel 1 once; the same step from the same
    state with the plain filter gives the same loss terms."""
    import copy
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import TCAMConfig
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss
    from tcam_wsol_video_tpu_torch.models import resnet
    from tcam_wsol_video_tpu_torch.models.unet import UnetFCAM
    args = TCAMConfig(task="F_CL", arch="UnetFCAM", crop_size=64,
                      batch_size=2, compute_dtype="float32", im_rec=True,
                      sl_fc=True, crf_fc=True, entropy_fc=True,
                      max_sizepos_fc=True, freeze_cl=True, sl_tc_min=3,
                      sl_tc_max=3)
    torch.manual_seed(0)
    model = UnetFCAM(resnet.ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10,
                     freeze_cl=True, im_rec=True).to(card)
    g = torch.Generator(device=card).manual_seed(0)
    batch = {"image": torch.randn((2, 64, 64, 3), generator=g, device=card),
             "raw_img": torch.rand((2, 64, 64, 3), generator=g,
                                   device=card) * 255.0,
             "label": torch.tensor([1, 4], device=card),
             "std_cam": torch.rand((2, 64, 64), generator=g, device=card),
             "roi": torch.ones((2, 64, 64), dtype=torch.int32, device=card)}
    master = get_loss(args)
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(bilateral, "_launch",
                                bilateral.gaussian_filter_apply_plain)
        m = copy.deepcopy(model)
        state = TrainState(m, build_optimizer(args, m, args.lr),
                           args.elb_init_t)
        bilateral.counts.reset()
        out[route] = make_train_step(master, args,
                                     seeder_cfg_from_args(args))(
            state, batch, master.switches(0), True,
            generator=torch.Generator(device=card).manual_seed(1))
        torch.cuda.synchronize()
        assert (bilateral.counts.kernel, bilateral.counts.plain) == (
            (1, 0) if route == "kernel" else (0, 1))
    assert set(out["kernel"]) >= {"img_reconstruction", "self_learning_fcams",
                                  "con_ran_field_fcams", "entropy_fcams",
                                  "max_size_positive_fcams"}
    for k, v in out["plain"].items():
        if v.is_floating_point():
            assert abs(float(out["kernel"][k]) - float(v)) <= \
                STEP_RTOL * abs(float(v)), k


# ----------------------------------------------------- the throughput layer
@pytest.fixture(scope="module")
def card_set(tmp_path_factory):
    """A small synthetic set written with nvJPEG and a stand-in CAM store
    (12 train shots: 6 steps of 2 an epoch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tcam_wsol_video_tpu_torch.data.synthetic import (
        make_stand_in_cam_store, make_synthetic_dataset)
    root = str(tmp_path_factory.mktemp("graphs"))
    out = make_synthetic_dataset(root, device=torch.device("cuda"))
    make_stand_in_cam_store(out["metadata_root"], root + "/cams")
    return root, out["metadata_root"]


def _feed_trainer(card, card_set, chunk: int, outd: str, **flags):
    """A Trainer over the card-resident feed (uint8 batches, exact CRF,
    fp32, the small ResNet) at train_dispatch_chunk `chunk`, with `flags`
    over those; two builds start from the same weights."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core.config import (finalize,
                                                       stage2_tcam_recipe)
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    from tcam_wsol_video_tpu_torch.models import resnet
    from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
    root, meta = card_set
    args = finalize(stage2_tcam_recipe(**{**dict(
        crop_size=64, resize_size=80, batch_size=2, eval_batch_size=8,
        compute_dtype="float32", data_root=root, metadata_root=meta,
        std_cams_folder=root + "/cams", h2d_transfer="uint8",
        train_device_cache_mb=64, train_dispatch_chunk=chunk, log_every=1,
        checkpoint_save=0, outd=outd, max_epochs=1,
        cam_curve_interval=0.05), **flags}))
    kc = KeyChain(0)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, card)
    torch.manual_seed(0)
    model = UnetTCAM(resnet.ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP",
                     args.num_classes, freeze_cl=True).to(card)
    return Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                   device=card)


def _logged_losses(outd: str) -> list:
    import glob
    import json
    (path,) = glob.glob(outd + "/**/log.json", recursive=True)
    with open(path) as f:
        return [json.loads(x)["loss"] for x in f
                if '"it"' in x and '"split": "train"' in x]


def test_graphed_chunks_match_eager_steps(card, card_set, tmp_path,
                                          monkeypatch):
    """An epoch of 6 steps as CUDA graphs of 4 steps and a tail of 2
    against the per-step loop from the same weights: the plan, the first
    step's loss (the same kernels on the same inputs), the epoch loss
    within JAX's rtol 1e-3, and kernel 1 counted once a step through the
    replays.  cuDNN's deterministic algorithms: its default backward of
    this small fp32 model adds in a varying order, which moves the second
    step's loss by ~2e-4 whatever the route."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for chunk in (0, 4):
        tr = _feed_trainer(card, card_set, chunk, str(tmp_path / str(chunk)))
        bilateral.counts.reset()
        rec = tr.train_epoch(0)
        runs[chunk] = (rec, bilateral.counts.kernel, bilateral.counts.plain,
                       _logged_losses(str(tmp_path / str(chunk))), tr)
    per, gr = runs[0], runs[4]
    assert per[0]["dispatch"] == "per_step" and gr[0]["dispatch"] == "chunked"
    assert per[0]["steps"] == gr[0]["steps"] == 6
    assert per[0]["n"] == gr[0]["n"]
    assert per[1] == gr[1] == 6 and per[2] == gr[2] == 0
    runner = gr[4]._chunk_runner
    assert (runner.replays, runner.captures) == (2, 2)
    assert len(per[3]) == len(gr[3]) == 6
    assert abs(gr[3][0] - per[3][0]) <= 1e-6 * abs(per[3][0])
    assert abs(gr[0]["loss"] - per[0]["loss"]) <= 1e-3 * abs(per[0]["loss"])


# the learning rate halves each epoch (a step schedule of step size 1),
# ELB's t anneals x 1.5 each epoch, and the CAM heat is on (a temporal
# window of one frame each side)
_EPOCH_SCHEDULE = dict(lr_scheduler="mystep", step_size=1, gamma=0.5,
                       elb_mulcoef=1.5, sl_tc_knn=1,
                       sl_tc_knn_mode="before-after", max_epochs=3)


def _feed_epochs(card, card_set, chunk: int, outd: str, epochs: int,
                 **flags):
    tr = _feed_trainer(card, card_set, chunk, outd,
                       **{**_EPOCH_SCHEDULE, **flags})
    return [tr.train_epoch(e) for e in range(epochs)], tr


@pytest.mark.parametrize("flags,captures,kept", [
    ({}, [2, 0, 0], [0, 2, 2]),
    ({"max_sizepos_tc_start_ep": 2}, [2, 0, 2], [0, 2, 0]),
], ids=["kept", "switch_on_at_2"])
def test_kept_graphs_match_per_step_over_epochs(card, card_set, tmp_path,
                                               monkeypatch, flags, captures,
                                               kept):
    """3 epochs of 6 steps at chunk 4 (graphs of 4 steps and a tail of 2)
    against the per-step loop, the learning rate, ELB t and heat read from
    the runner's device scalars: the graphs of epoch 0 replay in epochs 1
    and 2, and a loss switch that turns on at epoch 2 captures again.
    Each epoch's loss within JAX's rtol 1e-3; cuDNN's deterministic
    algorithms, as test_graphed_chunks_match_eager_steps."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    per, _ = _feed_epochs(card, card_set, 0, str(tmp_path / "per"), 3,
                          **flags)
    gr, tr = _feed_epochs(card, card_set, 4, str(tmp_path / "gr"), 3,
                          **flags)
    runner = tr._chunk_runner
    assert (runner.captures, runner.replays) == (sum(captures), 6)
    assert [r["counts"]["dispatch.captures"] for r in gr] == captures
    assert [r["counts"]["dispatch.kept"] for r in gr] == kept
    assert [r["capture_ms"] > 0 for r in gr] == [c > 0 for c in captures]
    assert len({r["elb_t"] for r in gr}) == 3
    for a, b in zip(per, gr):
        assert a["steps"] == b["steps"] == 6
        assert abs(b["loss"] - a["loss"]) <= 1e-3 * abs(a["loss"])


def test_kept_graphs_on_the_landmark_route(card, card_set, tmp_path,
                                           monkeypatch):
    """The landmark CRF (kernel 4, the batched ridge solve) over 2 epochs
    whose second replays the graphs of the first: no failed
    factorization, and the epoch losses as the per-step loop's."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    flags = dict(crf_impl="landmarks", crf_n_landmarks=1024)
    per, _ = _feed_epochs(card, card_set, 0, str(tmp_path / "per"), 2,
                          **flags)
    gr, tr = _feed_epochs(card, card_set, 4, str(tmp_path / "gr"), 2,
                          **flags)
    assert [r["counts"]["dispatch.kept"] for r in gr] == [0, 2]
    assert tr._chunk_runner.captures == 2
    assert [r["counts"]["crf.solve_failed"] for r in gr] == [0, 0]
    for a, b in zip(per, gr):
        assert abs(b["loss"] - a["loss"]) <= 1e-3 * abs(a["loss"])


def test_device_sweep_on_the_card_matches_the_host_sweep(card):
    import numpy as np
    from tcam_wsol_video_tpu_torch.metrics import device_sweep, native_sweep
    from tcam_wsol_video_tpu_torch.metrics.wsol import BoxEvaluator
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:56, 0:56]
    cams = []
    for i in range(12):
        cam = np.zeros((56, 56))
        for _ in range(1 + i % 3):
            cy, cx, s = rng.uniform(8, 48), rng.uniform(8, 48), \
                rng.uniform(3, 10)
            cam = np.maximum(cam, np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                         / (2 * s * s)))
        cams.append(cam)
    cams = np.stack(cams).astype(np.float32)
    cams[0, 20:30, 20:30] = 0.2                          # a hole
    gt = rng.integers(0, 30, (12, 2, 4)).astype(np.int32)
    gt[..., 2:] += 20
    gv = np.ones((12, 2), bool)
    hits, peak, fb = device_sweep.sweep_batch(torch.from_numpy(cams).to(card),
                                              gt, gv, (30, 50, 70))
    want = device_sweep.sweep_batch(torch.from_numpy(cams), gt, gv,
                                    (30, 50, 70))
    for g, w in zip((hits, peak, fb), want):
        assert torch.equal(g.cpu(), w)
    taus = np.arange(0.0, 1.0, 0.001)
    host = BoxEvaluator(taus, (30, 50, 70))
    dev = BoxEvaluator(taus, (30, 50, 70))
    best, _ = native_sweep.sweep_best_iou(cams, taus, list(gt))
    for i in range(12):
        host.accumulate_best_iou(best[i], 0, np.arange(5))
        dev.accumulate_level_hits(hits[i].cpu().numpy(), int(peak[i]), 0,
                                  np.arange(5))
    assert not fb.any()
    assert host.compute() == dev.compute()
    for s in (30, 50, 70):
        assert np.array_equal(host.num_correct[s], dev.num_correct[s])


def test_capture_failure_raises_without_an_eager_retry(card, card_set,
                                                       tmp_path):
    """A step that reads a value back to the host cannot be captured: the
    runner raises, the step ran once eagerly (the warm-up, undone) and
    once under capture, and the weights are those before the epoch."""
    tr = _feed_trainer(card, card_set, 4, str(tmp_path / "bad"))
    calls = {"n": 0}
    step = tr.train_step

    def syncing_step(*a, **k):
        calls["n"] += 1
        out = step(*a, **k)
        float(out["loss"])
        return out

    tr.train_step = syncing_step
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(RuntimeError):
        tr.train_epoch(0)
    assert calls["n"] == 2 and tr.state.step == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# a 2-rank step against one rank on the card: the loss terms and the
# BatchNorm's forward within fp32 rounding of the global batch's sums;
# the parameter updates relative to each tensor's largest update entry
# within 1e-1: on the card one rank against itself under another cuDNN
# algorithm choice already differs by 9.9e-2 at path A's model (PERF.md,
# PR 13), and this one read 4.8e-2
MESH_LOSS_RTOL = 1e-5
MESH_BN_RTOL = 1e-6
MESH_DELTA_RTOL = 1e-1


def test_global_batch_norm_and_a_two_rank_step_on_the_card(card):
    """Two ranks on the card (over gloo when there is one card: NCCL
    refuses two ranks on one device; NCCL with two cards) against one
    rank without a process group: the global BatchNorm's output and
    running statistics, then one fp32 TCAM step (TF32 off, cuDNN
    deterministic) on each rank's half of the batch, kernel 1 once on
    each rank (path N(b) of chip_smoke.py at a small size)."""
    import numpy as np

    import torch_mesh_ranks as ranks
    from torch_dist import Ranks
    from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
    from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
    backend = "nccl" if torch.cuda.device_count() > 1 else "gloo"
    group = Ranks(ranks.card_step, 2, 0, 8, 64, device="cuda",
                  backend=backend)
    one = ranks.card_step(0, 1, 0, 8, 64)
    two = group.join()
    y = np.concatenate([r["bn_y"] for r in two])
    assert np.abs(y - one["bn_y"]).max() <= MESH_BN_RTOL * np.abs(
        one["bn_y"]).max()
    for r in two:
        for k in ("bn_mean", "bn_var"):
            assert np.abs(r[k] - one[k]).max() <= MESH_BN_RTOL * np.abs(
                one[k]).max(), k
        assert r["launches"] == one["launches"] == 1
        for k, v in one["metrics"].items():
            assert abs(r["metrics"][k] - v) <= MESH_LOSS_RTOL * max(
                abs(v), 1e-6), k
    torch.manual_seed(0)          # the ranks' initial weights
    init = {k: v.numpy() for k, v in UnetTCAM(
        ResNetWSOL(layers=ranks.LAYERS), "WGAP", ranks.CLASSES
    ).state_dict().items()}
    for k, v in one["state"].items():
        np.testing.assert_array_equal(two[1]["state"][k],
                                      two[0]["state"][k], k)
        if k.endswith("num_batches_tracked"):
            assert int(two[0]["state"][k]) == int(v) == 1
            continue
        if "running_" in k:        # one forward's statistics, folded once
            assert np.abs(two[0]["state"][k] - v).max() <= 1e-4 * max(
                np.abs(v).max(), 1e-12), k
            continue
        d_one, d_two = v - init[k], two[0]["state"][k] - init[k]
        tol = (MESH_DELTA_RTOL * np.abs(d_one).max()
               + 4 * np.finfo(np.float32).eps * np.abs(init[k]).max())
        assert np.abs(d_two - d_one).max() <= tol, k


def test_nvjpeg_route_is_repeatable_under_load(card, tmp_path):
    """Two processes load the same 32 frames through the card's image
    route 8 times each while the card is busy: every batch equals the
    frames loaded one at a time.  Before the decoder waited for the
    previous decode's work before reusing its state, about a third of
    the frames came out wrong this way (chip_nvjpeg_stress.py; PERF.md,
    PR 13)."""
    import numpy as np

    import torch_mesh_ranks as ranks
    from torch_dist import Ranks
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    rng = np.random.default_rng(0)
    paths = []
    for i in range(32):
        img = (rng.random((270, 360, 3)) * 60).astype(np.uint8)
        img[50:200, 80:300] = rng.integers(0, 255, 3)
        p = str(tmp_path / f"f{i}.jpg")
        with open(p, "wb") as f:
            f.write(nvjpeg_loader.encode(img, 95))
        paths.append(p)
    bad = Ranks(ranks.nvjpeg_repeat, 2, paths, 8, device="cuda",
                backend="gloo").join()
    assert bad == [0, 0]
