"""Port parity: the train data plane (h2d_transfer=uint8, the decoded-frame
cache and the card-resident train feed) against the JAX package on the
CPU, and the port's feed against its own streamed route.

One synthetic set from the JAX generator (48 train frames of 90 x 120,
crop 32, resize 40, batch 4) with a CAM store of 1-3 Gaussian blobs a
frame (several components, for the ROI methods) and a stored threshold
for every frame.  Both packages decode through their own builds of
native/fastloader.cpp, so pixels must be bit-equal.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CROP, LAYERS, assert_close, jax_classifier,
                                 jax_model, jax_variables, torch_classifier,
                                 torch_model)
from tcam_wsol_video_tpu.cli import dump_cams as jdump
from tcam_wsol_video_tpu.core import checkpoint as jckpt
from tcam_wsol_video_tpu.core import constants as JC
from tcam_wsol_video_tpu.core.hparams import HParams, get_config
from tcam_wsol_video_tpu.core.prng import KeyChain as JKeyChain
from tcam_wsol_video_tpu.data import native_loader as jnative
from tcam_wsol_video_tpu.data import pipeline as jpipeline
from tcam_wsol_video_tpu.data.cam_store import CamStore as JCamStore
from tcam_wsol_video_tpu.data.dataset import WSOLVideoDataset as JDataset
from tcam_wsol_video_tpu.data.folds import \
    load_split_metadata as jload_split
from tcam_wsol_video_tpu.data.synthetic import \
    make_synthetic_dataset as jmake
from tcam_wsol_video_tpu.data.transforms import PairedTransform as JPT
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.engine import steps as jsteps
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_cam_eval_step as jeval
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.cli import dump_cams
from tcam_wsol_video_tpu_torch.cli import train as cli_train
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.core import constants as C
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.core.config import stage1_cam_recipe
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import native_loader
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.device_feed import DeviceTrainFeed
from tcam_wsol_video_tpu_torch.data.folds import load_split_metadata
from tcam_wsol_video_tpu_torch.data.pipeline import (DataPipeline,
                                                     card_cam_planes,
                                                     compact_batch,
                                                     host_cam_planes)
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
from tcam_wsol_video_tpu_torch.engine import steps
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
from tcam_wsol_video_tpu_torch.models.classifier import STDClassifier
from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
from test_torch_seeding import jax_gumbel
from test_torch_step import LOSS_RTOL, _batch, _jax_args, _recipe

torch.set_num_threads(1)

RESIZE, BATCH = 40, 4
METHODS = (C.ROI_ALL, C.ROI_LARGEST, C.ROI_H_DENSITY)
JMETHOD = {C.ROI_ALL: JC.ROI_ALL, C.ROI_LARGEST: JC.ROI_LARGEST,
           C.ROI_H_DENSITY: JC.ROI_H_DENSITY}
# the port's feed against JAX's feed: the same float32 operations up to
# the order of the resize matmuls' sums and an ulp of exp (heat), so the
# CAMs agree to ~1e-7 and a ROI pixel can flip only on its threshold
FEED_CAM_ATOL = 1e-6
FEED_FG_ATOL = 1e-5
FEED_ROI_AGREE = 0.999
# the feed against the streamed route (JAX tests/test_device_feed.py's
# tolerances): the streamed CAM is packed to uint16 (7.6e-6) after the
# host's float32 matrix resize; ROI pixels on a threshold may flip
STREAM_CAM_ATOL = 2e-4
STREAM_ROI_AGREE = 0.995
STREAM_FG_ATOL = 2e-3
# the eval CAMs after the step, refined by five mean-field iterations:
# the CAM's 1e-4, then the filters' fp32 noise through the softmax
# (test_torch_step.py's tolerance for the refined CAMs of float batches)
EVAL_CAM_RTOL = 1e-3
# one dump batch at h2d_transfer=uint8: the same CAMs as
# tests/test_torch_dump.py holds at float32
DUMP_CAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataplane"))
    out = jmake(root)
    store = CamStore(os.path.join(root, "cams"))
    md = load_split_metadata(out["metadata_root"], C.TRAINSET)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:12, 0:12].astype(np.float32)
    th = {}
    for shot in md.image_ids:
        for f in sorted(os.listdir(os.path.join(out["data_root"], shot))):
            cam = np.zeros((12, 12), np.float32)
            for _ in range(rng.integers(1, 4)):
                cy, cx = rng.uniform(1, 11, 2)
                s = rng.uniform(0.8, 2.5)
                cam = np.maximum(cam, rng.uniform(0.4, 1.0) * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
            store.save_cam(f"{shot}/{f}", cam)
            th[f"{shot}/{f}"] = float(rng.uniform(0.2, 0.5))
    store.save_thresholds(th)
    return {**out, "root": root, "cams": os.path.join(root, "cams")}


def _datasets(synth, knn, method, split=C.TRAINSET, knn_tc=0):
    train = split == C.TRAINSET
    mode = C.TIME_BEFORE_AFTER if knn else C.TIME_INSTANT
    kw = dict(crop_size=CROP, sl_tc_knn=knn, sl_tc_knn_mode=mode,
              use_roi=True, roi_method=method, p_min_area_roi=0.05,
              knn_tc=knn_tc)
    jds = JDataset(jload_split(synth["metadata_root"], split),
                   synth["data_root"], split, JC.YTOV1,
                   JPT(RESIZE, CROP, train=train), JKeyChain(7),
                   cam_store=JCamStore(synth["cams"]),
                   **{**kw, "roi_method": JMETHOD[method]})
    ds = WSOLVideoDataset(load_split_metadata(synth["metadata_root"], split),
                          synth["data_root"], split, C.YTOV1,
                          PairedTransform(RESIZE, CROP, train=train),
                          KeyChain(7), cam_store=CamStore(synth["cams"]),
                          **kw)
    return jds, ds


# ------------------------------------------------------ compact batches
def _float_batch(rng, b=6):
    raw = rng.uniform(-3.0, 258.0, (b, CROP, CROP, 3)).astype(np.float32)
    raw[0, 0, :8, 0] = np.arange(8) + 0.5      # exact halves: to even
    cam = rng.uniform(-0.1, 1.1, (b, CROP, CROP)).astype(np.float32)
    return {"image": rng.standard_normal((b, CROP, CROP, 3)).astype(
                np.float32),
            "raw_img": raw, "std_cam": cam,
            "roi": (cam > 0.5).astype(np.int32),
            "msk_bbox": (cam > 0.2).astype(np.float32),
            "label": rng.integers(0, 10, b).astype(np.int32)}


def test_compact_and_expand_bit_equal_to_jax():
    batch = _float_batch(np.random.default_rng(0))
    want = jpipeline.compact_batch(dict(batch))
    got = compact_batch(dict(batch))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["raw_u8"][0, 0, :8, 0].tolist() == [0, 2, 2, 4, 4, 6, 6, 8]
    jexp = jsteps.expand_compact_batch(
        {k: jnp.asarray(v) for k, v in want.items()})
    exp = steps.expand_compact_batch(got)
    assert set(exp) == set(jexp)
    for k, w in jexp.items():
        np.testing.assert_array_equal(np.asarray(exp[k]), np.asarray(w),
                                      err_msg=k)
        assert np.asarray(exp[k]).dtype == np.asarray(w).dtype, k


# ------------------------------------------------- decoded-frame cache
def test_decoded_frame_cache_matches_jax(synth):
    """Two epochs of batches of 10 with duplicates, at resize 200, through
    a budget of ~8 frames (eviction stops at the batch in flight): the
    same pixels, hits, misses, bytes and resident frames after every
    batch."""
    md = load_split_metadata(synth["metadata_root"], C.TRAINSET)
    frames = [f"{s}/{f}" for s in md.image_ids for f in sorted(
        os.listdir(os.path.join(synth["data_root"], s)))]
    budget_mb = 1
    jc = jnative.DecodedFrameCache(budget_mb)
    tc = native_loader.DecodedFrameCache(budget_mb)
    rng = np.random.default_rng(5)
    for epoch in range(2):
        order = rng.permutation(len(frames))
        for s in range(0, len(order), 8):
            paths = [os.path.join(synth["data_root"], frames[i])
                     for i in order[s:s + 8]]
            paths += paths[:2]                       # duplicates
            xs = rng.integers(0, 200 - CROP + 1, len(paths))
            ys = rng.integers(0, 200 - CROP + 1, len(paths))
            flips = rng.random(len(paths)) < 0.5
            want = jc.load_batch(paths, 200, CROP, xs, ys, flips)
            got = tc.load_batch(paths, 200, CROP, xs, ys, flips)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert (tc.hits, tc.misses, tc.bytes) == (jc.hits, jc.misses,
                                                      jc.bytes)
            assert list(tc.frames) == list(jc.frames)
    # evicted frames were decoded again, and some frames were served warm
    assert tc.misses > len(frames) and tc.hits > 0


# ------------------------------------------------ the card-resident feed
def _feeds(synth, knn, method):
    jds, ds = _datasets(synth, knn, method)
    jpipe = jpipeline.DataPipeline(jds, BATCH, JKeyChain(7), shuffle=True,
                                   num_workers=1, compact=True,
                                   train_device_cache_mb=64)
    pipe = DataPipeline(ds, BATCH, KeyChain(7), shuffle=True, compact=True,
                        train_device_cache_mb=64, device="cpu")
    assert jpipe._device_feed is not None
    assert pipe.data_route == "device_feed"
    return jpipe, pipe


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("knn", [0, 1])
def test_device_feed_matches_jax(synth, knn, method):
    jpipe, pipe = _feeds(synth, knn, method)
    for epoch in (0, 1):
        jb = list(jpipe.epoch(epoch))
        pb = list(pipe.epoch(epoch))
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            assert a["image_id"] == b["image_id"]
            for k in ("raw_u8", "label", "valid", "seq_iter", "frm_iter",
                      "has_cam"):
                np.testing.assert_array_equal(b[k].numpy(),
                                              np.asarray(a[k]), err_msg=k)
            np.testing.assert_allclose(b["std_cam"].numpy(),
                                       np.asarray(a["std_cam"]),
                                       atol=FEED_CAM_ATOL, rtol=0)
            agree = (b["roi"].numpy() == np.asarray(a["roi"])).mean()
            assert agree >= FEED_ROI_AGREE, agree
            np.testing.assert_allclose(b["fg_size"].numpy(),
                                       np.asarray(a["fg_size"]),
                                       atol=FEED_FG_ATOL, rtol=0)
            assert b["roi"].dtype == torch.int32
            assert b["msk_bbox"].dtype == torch.float32
            if agree == 1.0:
                np.testing.assert_array_equal(b["msk_bbox"].numpy(),
                                              np.asarray(a["msk_bbox"]))
    feed = pipe.device_feed
    assert feed.decodes.max() == 1
    assert feed.decodes.sum() == feed.resident.sum() > 0


# (knn_tc, batch): clips of 3 frames at 5 clips a batch, so the last batch
# of the 12 shots holds 2 clips and is tiled with whole clips to 15 frames
SHORT_TAIL = (1, 5)


@pytest.mark.parametrize("knn,knn_tc,batch", [
    pytest.param(0, 0, BATCH, id="0"), pytest.param(1, 0, BATCH, id="1"),
    pytest.param(1, *SHORT_TAIL, id="1-clips_short_tail")])
def test_device_feed_replays_the_streamed_route(synth, knn, knn_tc, batch):
    """The port's feed against its own streamed compact route with the
    decoded-frame cache: the same ids, bit-equal pixels, the CAM side
    within the packing and float rounding; a short batch of clips is
    tiled alike, its repeats invalid."""
    _, ds_s = _datasets(synth, knn, C.ROI_LARGEST, knn_tc=knn_tc)
    _, ds_d = _datasets(synth, knn, C.ROI_LARGEST, knn_tc=knn_tc)
    pipe_s = DataPipeline(ds_s, batch, KeyChain(7), compact=True,
                          decode_cache_mb=64, device="cpu")
    pipe_d = DataPipeline(ds_d, batch, KeyChain(7), compact=True,
                          train_device_cache_mb=64, device="cpu")
    assert pipe_s.data_route == "stream"
    frames = len(ds_s) * ds_s.clip_len
    for epoch in (0, 1):
        n_valid = 0
        for bs, bd in zip(pipe_s.epoch(epoch), pipe_d.epoch(epoch),
                          strict=True):
            n_valid += int(bd["valid"].sum())
            assert bs["image_id"] == bd["image_id"]
            for k in ("raw_u8", "label", "valid", "seq_iter", "frm_iter"):
                np.testing.assert_array_equal(bs[k].numpy(), bd[k].numpy(),
                                              err_msg=k)
            exp = steps.expand_compact_batch(bs)
            np.testing.assert_allclose(bd["std_cam"].numpy(),
                                       exp["std_cam"].numpy(),
                                       atol=STREAM_CAM_ATOL, rtol=0)
            agree = (exp["roi"].numpy() == bd["roi"].numpy()).mean()
            assert agree >= STREAM_ROI_AGREE, agree
            np.testing.assert_allclose(bd["fg_size"].numpy(),
                                       bs["fg_size"].numpy(),
                                       atol=STREAM_FG_ATOL, rtol=0)
        # the streamed route decodes the real frames only
        assert n_valid == frames
        stats = pipe_s.epoch_stats()
        assert stats["data_route"] == "stream"
        assert stats["cache_hits"] + stats["cache_misses"] == frames
    assert pipe_s.epoch_stats()["cache_misses"] == 0    # nothing new


@pytest.fixture(scope="module")
def otsu_cams(synth, tmp_path_factory):
    """The synthetic store's CAMs without its thresholds file."""
    dst = str(tmp_path_factory.mktemp("otsu") / "cams")
    shutil.copytree(synth["cams"], dst,
                    ignore=shutil.ignore_patterns("roi_thresholds.txt"))
    return dst


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("thresholds", ["stored", "otsu"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("knn,heat", [(0, False), (1, False), (1, True)],
                         ids=["knn0", "knn1", "knn1_heat"])
def test_card_cam_planes_match_the_host_route(synth, otsu_cams, knn, heat,
                                              train, thresholds, method):
    """The streamed route's card CAM side (pipeline.card_cam_planes over
    device_feed.assemble_cam_planes, here on the CPU) against its host
    route, cam_roi_for frame by frame, on every train frame with random
    crops and flips (train) or the eval transform; within the tolerances
    of the feed against the streamed route."""
    mode = C.TIME_BEFORE_AFTER if knn else C.TIME_INSTANT
    decay = (DecayTemp(sl_tc_knn_t=4.0, sl_tc_min_t=1.0, sl_tc_knn=knn,
                       sl_tc_knn_mode=mode, sl_tc_knn_epoch_switch_uniform=-1,
                       sl_tc_seed_tech=C.SEED_WEIGHTED) if heat else None)
    cams = synth["cams"] if thresholds == "stored" else otsu_cams
    ds = WSOLVideoDataset(
        load_split_metadata(synth["metadata_root"], C.TRAINSET),
        synth["data_root"], C.TRAINSET, C.YTOV1,
        PairedTransform(RESIZE, CROP, train=train), KeyChain(7),
        crop_size=CROP, cam_store=CamStore(cams), sl_tc_knn=knn,
        sl_tc_knn_mode=mode, decay_temp=decay, use_roi=True,
        roi_method=method, p_min_area_roi=0.05)
    assert ds.cam_heat() == (4.0 if heat else 0.0)
    fids = sorted(ds.frame_to_shot)
    rng = np.random.default_rng(knn + 2 * train)
    n = len(fids)
    if train:
        r = RESIZE
        ys, xs = (rng.integers(0, r - CROP + 1, n).tolist() for _ in "yx")
        flips = rng.integers(0, 2, n).tolist()
        assert 0 < sum(flips) < n
    else:
        r = CROP
        ys = xs = flips = [0] * n
    got = card_cam_planes(ds, fids, ys, xs, flips, r, torch.device("cpu"))
    want = host_cam_planes(ds, fids, ys, xs, flips)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.from_numpy(w).dtype, k
        assert got[k].shape == w.shape, k
    np.testing.assert_array_equal(got["has_cam"].numpy(), want["has_cam"])
    np.testing.assert_allclose(got["std_cam"].numpy(), want["std_cam"],
                               atol=STREAM_CAM_ATOL, rtol=0)
    agree = (got["roi"].numpy() == want["roi"]).mean()
    assert agree >= STREAM_ROI_AGREE, agree
    np.testing.assert_allclose(got["fg_size"].numpy(), want["fg_size"],
                               atol=STREAM_FG_ATOL, rtol=0)
    if agree == 1.0:
        np.testing.assert_array_equal(got["msk_bbox"].numpy(),
                                      want["msk_bbox"])


def test_cpu_pipeline_keeps_the_host_cam_route(synth):
    """On a CPU device every streamed batch over a store takes the host
    CAM side, and the counter says so."""
    _, ds = _datasets(synth, 1, C.ROI_LARGEST)
    pipe = DataPipeline(ds, BATCH, KeyChain(7), device="cpu")
    TRACE.take()
    batches = list(pipe.epoch(0))
    spans, counts = TRACE.take()
    assert counts.get("data.cams_host") == len(ds) == 12
    assert "data.cams_card" not in counts
    assert spans["data.cams"][0] == len(batches) == 3


def test_card_cam_planes_refuse_stored_cams_of_two_shapes(synth, tmp_path):
    """A batch whose stored CAMs differ in shape gets no card planes (the
    pipeline then takes the host route, which resizes each CAM alone)."""
    cams = str(tmp_path / "cams")
    shutil.copytree(synth["cams"], cams)
    _, ds = _datasets(synth, 0, C.ROI_ALL)
    ds.cam_store = CamStore(cams)
    fids = sorted(ds.frame_to_shot)[:4]
    ds.cam_store.save_cam(fids[1], np.ones((10, 10), np.float32))
    args = (ds, fids, [0, 1, 2, 3], [3, 2, 1, 0], [0, 1, 0, 1], RESIZE)
    assert card_cam_planes(*args, torch.device("cpu")) is None
    assert host_cam_planes(*args[:5])["has_cam"].tolist() == [1.0] * 4
    assert card_cam_planes(ds, fids[2:], [0, 1], [3, 2], [0, 1], RESIZE,
                           torch.device("cpu")) is not None


def test_device_feed_off_for_eval_and_over_budget(synth):
    _, ds = _datasets(synth, 0, C.ROI_ALL)
    pipe = DataPipeline(ds, BATCH, KeyChain(7), device="cpu")
    assert not DeviceTrainFeed(pipe, 0).enabled
    _, ds_v = _datasets(synth, 0, C.ROI_ALL, split=C.VALIDSET)
    pipe_v = DataPipeline(ds_v, BATCH, KeyChain(7), shuffle=False,
                          train_device_cache_mb=64, device="cpu")
    assert pipe_v.data_route == "stream"


# ----------------------------------------------------------- the steps
def test_tcam_step_from_a_compact_batch_matches_jax():
    """One fp32 TCAM step, each package on its own packing of the same
    float batch, then each eval step (CRF refinement on) on the uint8
    pixels alone, as the evaluator passes a compact batch."""
    targs = _recipe()
    args = _jax_args(targs.replace(crf_post_process=True))
    batch = _batch(2)
    batch["raw_img"][0, 0, :4, 0] = [0.5, 1.5, 2.5, 254.5]
    jpacked = jpipeline.compact_batch(dict(batch))
    tpacked = compact_batch(dict(batch))

    jm = jax_model(freeze_cl=True)
    variables = jax_variables(jm, seed=1)
    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    jstate = JState.create(variables, opt.init(variables["params"]),
                           args.elb_init_t)
    scfg = JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)
    key = jax.random.PRNGKey(9)
    new_jstate, jmet = jstep(jm, ml, opt, args, scfg)(
        jstate, {k: jnp.asarray(v) for k, v in jpacked.items()},
        ml.switches(0), key, jnp.float32(1.0))
    jcams, _ = jeval(jm, args)(
        new_jstate.params, new_jstate.batch_stats,
        jnp.asarray(jpacked["raw_u8"]), jnp.asarray(jpacked["label"]), key)

    tm = torch_model(variables, freeze_cl=True)
    tstate = TrainState(tm, build_optimizer(targs, tm, targs.lr),
                        targs.elb_init_t)
    tml = get_loss_tcam(targs)
    k_seed, _ = jax.random.split(key)
    gumbel = torch.from_numpy(jax_gumbel(k_seed, 2, CROP * CROP))
    tbatch = {k: torch.as_tensor(v) for k, v in tpacked.items()}
    tbatch["label"] = tbatch["label"].long()
    tmet = steps.make_train_step(tml, targs, seeder_cfg_from_args(targs))(
        tstate, tbatch, tml.switches(0), True, gumbel=gumbel)
    tcams, _ = steps.make_cam_eval_step(
        tm, targs.replace(crf_post_process=True))(tbatch["raw_u8"])
    for term, want in jmet.items():
        if term in tmet and term not in ("n_correct", "n"):
            assert_close(tmet[term].numpy(), want, LOSS_RTOL, term)
    assert_close(tcams.numpy(), jcams, EVAL_CAM_RTOL, "eval cams")


# ------------------------------------------------------------ the dump
def test_dump_at_uint8_matches_jax(synth, tmp_path, monkeypatch):
    """The dump under --h2d_transfer uint8 normalizes as JAX's does,
    (v - 255 mean) / (255 std): each package's store from the same
    classifier."""
    jm = jax_classifier()
    variables = jax_variables(jm, seed=11)
    jexp, texp = str(tmp_path / "jexp"), str(tmp_path / "texp")
    jckpt.save_best_model(os.path.join(jexp, C.BEST_LOC), 7, variables)
    ckpt.save_best_model(os.path.join(texp, C.BEST_LOC), 7,
                         torch_classifier(variables))
    monkeypatch.setattr(jdump, "create_model_from_args",
                        lambda *a, **k: jm)
    monkeypatch.setattr(
        dump_cams, "create_model_from_args",
        lambda *a, **k: STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", 10))
    cfg = get_config(JC.YTOV1)
    cfg.update(dict(stage1_cam_recipe(
        crop_size=CROP, data_root=synth["root"],
        metadata_root=synth["metadata_root"]).__dict__))
    cfg.update(compute_dtype="float32", h2d_transfer="uint8")
    jdump.dump_cams(HParams(cfg), jexp, str(tmp_path / "jstore"))
    dump_cams.main([
        "--task", "STD_CL", "--data_root", synth["root"],
        "--metadata_root", synth["metadata_root"], "--crop_size", str(CROP),
        "--exp_dir", texp, "--out", str(tmp_path / "tstore"),
        "--device", "cpu", "--compute_dtype", "float32",
        "--h2d_transfer", "uint8"])
    js, ts_ = CamStore(str(tmp_path / "jstore")), CamStore(
        str(tmp_path / "tstore"))
    assert set(js.thresholds) == set(ts_.thresholds)
    err = max(np.abs(ts_.load_cam(f).astype(np.float64) - js.load_cam(f))
              .max() for f in js.thresholds)
    assert err <= DUMP_CAM_ATOL, err


# ------------------------------------------------------------- the CLI
def _cli_flags(synth, outd, *extra):
    return ["--device", "cpu", "--task", "TCAM", "--arch", "UnetTCAM",
            "--data_root", synth["root"], "--metadata_root",
            synth["metadata_root"], "--std_cams_folder", synth["cams"],
            "--crop_size", str(CROP), "--batch_size", str(BATCH),
            "--eval_batch_size", "8", "--max_epochs", "2",
            "--cam_curve_interval", "0.05", "--freeze_cl", "true",
            "--sl_tc", "true", "--sl_tc_seed_tech", "seed_weighted",
            "--sl_tc_use_roi", "true", "--sl_tc_roi_method", "roi_largest",
            "--sl_tc_knn", "1", "--sl_tc_knn_mode", "before", "--crf_tc",
            "true", "--max_sizepos_tc", "true", "--checkpoint_save", "0",
            "--log_every", "0", "--outd", outd, "--h2d_transfer", "uint8",
            "--decode_cache_mb", "64", *extra]


@pytest.mark.parametrize("resize,budget,route", [
    (RESIZE, 64, "device_feed"), (200, 1, "stream")],
    ids=["feed", "over_budget"])
def test_cli_trains_with_the_data_plane_flags(synth, tmp_path, resize,
                                              budget, route):
    out = cli_train.main(_cli_flags(
        synth, str(tmp_path), "--resize_size", str(resize),
        "--train_device_cache_mb", str(budget)))
    train = out["records"]["train"]
    assert len(train) == 2
    for r in train:
        assert r["data_route"] == route
        assert np.isfinite(r["loss"])
    if route == "device_feed":
        # each frame is decoded once in the run; the 12 shots a epoch
        # miss only frames that were never sampled before
        assert train[0]["pool_decodes"] == train[0]["pool_misses"] > 0
        assert sum(r["pool_decodes"] for r in train) <= 48
        assert train[0]["data_assembly_ms_per_step"] > 0
    else:
        assert all(r["pool_decodes"] == 0 for r in train)
        assert train[0]["cache_misses"] == 12
    assert out["test"][C.BEST_LOC]["n_images"] > 0


def test_cli_refuses_what_is_not_ported(synth, tmp_path):
    """--bucket_sz is ported: it parses as JAX's parse_args parses it;
    h2d_transfer uint16 is refused, as in JAX."""
    from tcam_wsol_video_tpu.core.hparams import parse_args as jparse
    from tcam_wsol_video_tpu_torch.core.config import parse_args
    flags = ["--bucket_sz", "4", "--ds_chunkable", "true", "--nbr_chunks",
             "12"]
    got, _ = parse_args(flags)
    want = jparse(flags)
    assert (got.bucket_sz, got.ds_chunkable, got.nbr_chunks,
            got.nbr_buckets) == (want.bucket_sz, want.ds_chunkable,
                                 want.nbr_chunks, want.nbr_buckets) == \
        (4, True, 12, 3)
    with pytest.raises(ValueError):
        cli_train.main(_cli_flags(synth, str(tmp_path), "--h2d_transfer",
                                  "uint16"))
