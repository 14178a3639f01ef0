"""Port parity: loss_chunk (MasterLoss.compute_chunked) and remat
(engine/steps.remat_forward) on the CPU, in float32.

- compute_chunked against JAX's compute_chunked on the same numpy inputs
  (the TCAM losses of JAX tests/test_losses.py's chunk test: CE with
  uneven ignore counts a frame, the exact CRF, the temporal joint CRF over
  clips of 3, three ELB priors): the total and each term within
  CHUNK_RTOL, the logits' gradient within GRAD_RTOL;
- compute_chunked against the port's unchunked compute, and its refusals
  (a chunk that does not divide the batch, or splits a clip);
- a train step with remat, loss_chunk, or both, against the plain step
  from the same state, batch and noise, on ResNet-50 and on InceptionV3
  (whose SPG dropout draws masks in training): the loss terms, the
  parameters, the BN running statistics and the dropout generator's state
  after the step within REMAT_ATOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu.losses.core import LossInputs as JInputs
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, finalize
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss, get_loss_tcam
from tcam_wsol_video_tpu_torch.losses.core import LossInputs
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args

torch.set_num_threads(1)

# the port's chunked losses against JAX's (tests/test_losses.py:122 holds
# JAX's chunked against its unchunked at 2e-5): fp32 sums in another order
CHUNK_RTOL = 1e-5
# the logits' gradient, relative L2 over the whole tensor
GRAD_RTOL = 1e-5
# chunked against unchunked in the port (JAX's own test's tolerances)
SELF_RTOL = 2e-5
SELF_GRAD_RTOL = 1e-4
# a remat or loss_chunk step against the plain step: the same operations
# recomputed (remat) or summed by groups (loss_chunk)
REMAT_ATOL = 1e-6
T = 5.0
B, H = 12, 16                      # 4 clips of 3 frames


def _args(**kw) -> TCAMConfig:
    return TCAMConfig(task=C.TCAM, arch=C.UNETTCAM, crop_size=H, sl_tc=True,
                      crf_tc=True, crf_impl="exact", rgb_jcrf_tc=True,
                      knn_tc=1, max_sizepos_tc=True,
                      max_sizepos_tc_lambda=0.01, size_bg_g_fg_tc=True,
                      empty_out_bb_tc=True).replace(**kw)


def _inputs(args) -> dict:
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2, (B, H, H)).astype(np.int32)
    # uneven ignore counts a frame: the CE's denominator case
    seeds[rng.random((B, H, H)) < rng.random((B, 1, 1))] = \
        args.seg_ignore_idx
    return {
        "fcams": rng.standard_normal((B, H, H, 2)).astype(np.float32),
        "raw_img": (rng.random((B, H, H, 3)) * 255).astype(np.float32),
        "seeds": seeds,
        "fg_size": rng.random(B).astype(np.float32),
        "msk_bbox": (rng.random((B, H, H)) > 0.5).astype(np.float32),
        "seq_iter": np.repeat(np.arange(4), 3).astype(np.float32),
        "frm_iter": np.tile(np.arange(3), 4).astype(np.float32)}


def _torch_loss(ml, arrays, chunk):
    fcams = torch.from_numpy(arrays["fcams"]).requires_grad_(True)
    inp = LossInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()
                        if k != "fcams"}, fcams=fcams)
    sw = ml.switches(0)
    total, holder = (ml.compute_chunked(inp, T, sw, chunk) if chunk
                     else ml.compute(inp, T, sw))
    (grad,) = torch.autograd.grad(total, fcams)
    return (total.item(), {k: v.item() for k, v in holder.items()},
            grad.numpy())


def _jax_loss(args, arrays, chunk):
    cfg = get_config(JC.YTOV1)
    cfg.update(args.__dict__)
    ml = jget_loss(HParams(cfg))
    inp = JInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    sw = ml.switches(0)
    t = jnp.float32(T)
    total, holder = ml.compute_chunked(inp, t, sw, chunk)
    grad = jax.grad(lambda f: ml.compute_chunked(
        dataclasses.replace(inp, fcams=f), t, sw, chunk)[0])(inp.fcams)
    return (float(total), {k: float(v) for k, v in holder.items()},
            np.asarray(grad))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("chunk", [3, 6, 12])
def test_compute_chunked_matches_jax(chunk):
    args = _args()
    arrays = _inputs(args)
    ml = get_loss_tcam(args)
    assert len(ml.losses) == 6
    got_t, got_h, got_g = _torch_loss(ml, arrays, chunk)
    want_t, want_h, want_g = _jax_loss(args, arrays, chunk)
    np.testing.assert_allclose(got_t, want_t, rtol=CHUNK_RTOL)
    assert set(got_h) == set(want_h)
    for k in want_h:
        np.testing.assert_allclose(got_h[k], want_h[k], rtol=CHUNK_RTOL,
                                   atol=1e-7, err_msg=k)
    assert _rel_l2(got_g, want_g) <= GRAD_RTOL


@pytest.mark.parametrize("chunk", [3, 6])
def test_compute_chunked_matches_unchunked(chunk):
    args = _args()
    arrays = _inputs(args)
    ml = get_loss_tcam(args)
    got_t, got_h, got_g = _torch_loss(ml, arrays, chunk)
    want_t, want_h, want_g = _torch_loss(ml, arrays, 0)
    np.testing.assert_allclose(got_t, want_t, rtol=SELF_RTOL)
    for k in want_h:
        np.testing.assert_allclose(got_h[k], want_h[k], rtol=SELF_RTOL,
                                   atol=1e-7, err_msg=k)
    assert _rel_l2(got_g, want_g) <= SELF_GRAD_RTOL


@pytest.mark.parametrize("chunk", [5, 4], ids=["not_dividing",
                                               "splits_clips"])
def test_compute_chunked_refuses(chunk):
    args = _args()
    arrays = _inputs(args)
    with pytest.raises(ValueError, match="loss_chunk"):
        _torch_loss(get_loss_tcam(args), arrays, chunk)


# ------------------------------------------------------ the train step
def _step_args(encoder: str, **kw) -> TCAMConfig:
    return finalize(TCAMConfig(
        task=C.TCAM, arch=C.UNETTCAM, encoder_name=encoder, crop_size=32,
        batch_size=4, compute_dtype="float32", sl_tc=True, sl_tc_min=2,
        sl_tc_max=2, sl_tc_use_roi=True, crf_tc=True, max_sizepos_tc=True,
        max_sizepos_tc_lambda=0.01, freeze_cl=False).replace(**kw))


def _step(args, seed: int = 0):
    """One train step from random weights made from `seed`; returns the
    metrics, the state dict and the dropout generator's state after."""
    rng = np.random.default_rng(seed)
    b, c = 4, 32
    cam = rng.random((b, c, c)).astype(np.float32)
    batch = {
        "image": torch.from_numpy(rng.standard_normal((b, c, c, 3)
                                                      ).astype(np.float32)),
        "raw_img": torch.from_numpy((rng.random((b, c, c, 3)) * 255
                                     ).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 10, b)),
        "std_cam": torch.from_numpy(cam),
        "roi": torch.from_numpy((cam > 0.5).astype(np.int32)),
        "msk_bbox": torch.ones((b, c, c)),
        "fg_size": torch.full((b,), 0.3)}
    gumbel = torch.from_numpy(rng.gumbel(size=(b, 2, c * c)).astype(
        np.float32))
    torch.manual_seed(seed)
    model = create_model_from_args(args, device="cpu")
    opt = build_optimizer(args, model, 0.01)
    state = TrainState(model, opt, elb_t=1.0)
    step = make_train_step(get_loss(args), args, seeder_cfg_from_args(args))
    gen = torch.Generator().manual_seed(11)
    metrics = step(state, batch, get_loss(args).switches(0),
                   seed_weighted=False, gumbel=gumbel,
                   dropout_generator=gen)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            gen.get_state())


@pytest.mark.parametrize("encoder", [C.RESNET50, C.INCEPTIONV3])
@pytest.mark.parametrize("knobs", [dict(remat=True), dict(loss_chunk=2),
                                   dict(remat=True, loss_chunk=2)],
                         ids=["remat", "loss_chunk", "both"])
def test_step_matches_the_plain_step(encoder, knobs):
    m0, sd0, g0 = _step(_step_args(encoder))
    m1, sd1, g1 = _step(_step_args(encoder, **knobs))
    assert set(m0) == set(m1)
    for k in m0:
        assert abs(m1[k] - m0[k]) <= REMAT_ATOL * max(1.0, abs(m0[k])), k
    bn = [k for k in sd0 if k.endswith(("running_mean", "running_var",
                                        "num_batches_tracked"))]
    assert bn
    for k in sd0:
        np.testing.assert_allclose(sd1[k].double().numpy(),
                                   sd0[k].double().numpy(), rtol=0,
                                   atol=REMAT_ATOL, err_msg=k)
    # the recompute drew its masks again from the restored generator and
    # left it where the forward had
    assert torch.equal(g0, g1)
    if encoder == C.INCEPTIONV3:
        assert not torch.equal(g0, torch.Generator().manual_seed(11)
                               .get_state())
