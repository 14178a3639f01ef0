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


def test_bf16_tcam_step_on_the_card(card, monkeypatch):
    """One stage-2 step at the default compute dtype (bfloat16) on the
    card: every convolution hands cuDNN bf16 inputs and weights, the
    exact CRF kernel (fp32 inputs, as JAX casts them) launches once, no
    plain version runs, and the parameters and their gradients stay
    fp32."""
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import stage2_tcam_recipe
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    from tcam_wsol_video_tpu_torch.models import resnet
    from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
    args = stage2_tcam_recipe(crop_size=64, batch_size=2)
    assert args.compute_dtype == "bfloat16"
    torch.manual_seed(0)
    model = UnetTCAM(resnet.ResNetWSOL(layers=(1, 1, 1, 1)), "WGAP", 10,
                     freeze_cl=True).to(card)
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
    met = make_train_step(master, args, seeder_cfg_from_args(args))(
        state, batch, master.switches(0), True,
        generator=torch.Generator(device=card).manual_seed(1))
    torch.cuda.synchronize()
    assert seen == {(torch.bfloat16, torch.bfloat16, "cuda")}
    assert bilateral.counts.kernel == 1
    assert all(c.plain == 0 for c in counters)
    assert all(bool(torch.isfinite(v).all()) for v in met.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)


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


def _feed_trainer(card, card_set, chunk: int, outd: str):
    """A Trainer over the card-resident feed (uint8 batches, exact CRF,
    fp32, the small ResNet) at train_dispatch_chunk `chunk`; two builds
    start from the same weights."""
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core.config import (finalize,
                                                       stage2_tcam_recipe)
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    from tcam_wsol_video_tpu_torch.models import resnet
    from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
    root, meta = card_set
    args = finalize(stage2_tcam_recipe(
        crop_size=64, resize_size=80, batch_size=2, eval_batch_size=8,
        compute_dtype="float32", data_root=root, metadata_root=meta,
        std_cams_folder=root + "/cams", h2d_transfer="uint8",
        train_device_cache_mb=64, train_dispatch_chunk=chunk, log_every=1,
        checkpoint_save=0, outd=outd, max_epochs=1,
        cam_curve_interval=0.05))
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
