"""Port parity: the eval knobs (eval_sweep, eval_transfer,
eval_pipeline_depth, eval_device_cache, on_device_eval) on the CPU.

- metrics/device_sweep.level_hits bit-equal to JAX's level_hits on the
  cases of JAX tests/test_device_sweep.py (crafted maps, a random batch,
  several GT boxes, a run overflow that sets the fallback bit), and the
  counters it gives equal to the port's host sweep (native/boxsweep.cpp);
- render_uint8, pack_cams and dequantize_cams_np exact for all 256 levels;
- metrics/device_eval.batch_counters and max_box_acc equal to JAX's;
- CamEvaluator: the exact counters identical across eval_transfer
  float32/uint16/uint8, eval_pipeline_depth 1/8, eval_sweep host/device
  (with its host-swept fallbacks) and the device cache's recording and
  replay (after JAX tests/test_e2e.py:499-558, 728-765); a zero budget
  records nothing; the device sweep equal to JAX's evaluator on injected
  CAMs; on_device_eval's approximate counters equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_device_sweep import SIGMAS, _crafted_maps
from test_torch_eval import _SCALARS, _args, _evaluators, val_split  # noqa
from torch_port_fixtures import jax_model, jax_variables, torch_model
from tcam_wsol_video_tpu.metrics import device_eval as jdevice_eval
from tcam_wsol_video_tpu.metrics import device_sweep as jsweep
from tcam_wsol_video_tpu_torch.engine import evaluator
from tcam_wsol_video_tpu_torch.engine.steps import (dequantize_cams_np,
                                                    pack_cams)
from tcam_wsol_video_tpu_torch.metrics import (device_eval, device_sweep,
                                               native_sweep)
from tcam_wsol_video_tpu_torch.metrics.wsol import BoxEvaluator

torch.set_num_threads(1)


def _gt(gts, max_g=4):
    b = len(gts)
    gt = np.zeros((b, max_g, 4), np.int32)
    gv = np.zeros((b, max_g), bool)
    for i, g in enumerate(gts):
        g = np.asarray(g, np.float64).reshape(-1, 4)
        gt[i, :len(g)] = g.astype(np.int32)
        gv[i, :len(g)] = True
    return gt, gv


def _both_hits(q, gt, gv, max_runs):
    got = device_sweep.level_hits(torch.from_numpy(q), torch.from_numpy(gt),
                                  torch.from_numpy(gv), SIGMAS,
                                  max_runs=max_runs)
    want = jsweep.level_hits(jnp.asarray(q), jnp.asarray(gt),
                             jnp.asarray(gv), SIGMAS, max_runs=max_runs)
    for g, w, name in zip(got, want, ("hits", "peak", "fallback")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return [g.numpy() for g in got]


def _counters_equal(a: BoxEvaluator, b: BoxEvaluator) -> None:
    assert a.cnt == b.cnt
    for s in SIGMAS:
        for attr in ("num_correct", "num_correct_top1", "num_correct_top5"):
            np.testing.assert_array_equal(getattr(a, attr)[s],
                                          getattr(b, attr)[s])
    assert a.compute() == b.compute()
    assert a.best_tau_list == b.best_tau_list


def _host_vs_device(q, gts, hits, peak, taus, targets=None, preds=None):
    """The port's host sweep against accumulate_level_hits."""
    n = q.shape[0]
    targets = targets or [0] * n
    preds = preds or [np.arange(5)] * n
    host = BoxEvaluator(list(taus), list(SIGMAS))
    dev = BoxEvaluator(list(taus), list(SIGMAS))
    best, _ = native_sweep.sweep_best_iou(
        q.astype(np.float32) / 255.0, taus,
        [np.asarray(g, np.float32).reshape(-1, 4) for g in gts])
    for i in range(n):
        host.accumulate_best_iou(best[i], targets[i], preds[i])
        dev.accumulate_level_hits(hits[i], int(peak[i]), targets[i],
                                  preds[i])
    _counters_equal(host, dev)


@pytest.mark.parametrize("interval", [0.05, 0.001])
def test_level_hits_crafted_maps(interval):
    cases = _crafted_maps()
    q = np.stack([c[1] for c in cases])
    gts = [c[2] for c in cases]
    gt, gv = _gt(gts)
    hits, peak, fb = _both_hits(q, gt, gv, max_runs=16)
    assert not fb.any()
    _host_vs_device(q, gts, hits, peak, np.arange(0.0, 1.0, interval))


def test_level_hits_random_batch():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (6, 19, 23), np.uint8)
    q[rng.random(q.shape) < 0.6] = 0
    gts = [[[int(x0), int(y0), int(x0 + dw), int(y0 + dh)]]
           for x0, y0, dw, dh in rng.integers(0, 10, (6, 4))]
    gt, gv = _gt(gts)
    hits, peak, fb = _both_hits(q, gt, gv, max_runs=16)
    assert not fb.any()
    _host_vs_device(q, gts, hits, peak, np.arange(0.0, 1.0, 0.01))


def test_level_hits_several_gt_boxes_and_top_counters():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 200, (3, 16, 16), np.uint8)
    gts = [[[1, 1, 8, 8], [9, 9, 15, 15], [0, 12, 4, 15]],
           [[2, 2, 13, 13]], [[5, 0, 10, 6], [0, 0, 15, 15]]]
    gt, gv = _gt(gts)
    hits, peak, fb = _both_hits(q, gt, gv, max_runs=16)
    assert not fb.any()
    _host_vs_device(q, gts, hits, peak, np.arange(0.0, 1.0, 0.05),
                    targets=[0, 2, 4],
                    preds=[np.asarray([0, 1, 2, 3, 4]),
                           np.asarray([1, 0, 2, 3, 4]),
                           np.asarray([1, 2, 3, 0, 4])])


def test_run_overflow_sets_the_fallback_bit():
    noisy = np.zeros((16, 20), np.uint8)
    noisy[:, ::2] = 200                      # 10 runs a row
    blob = np.zeros((16, 20), np.uint8)
    blob[4:12, 5:15] = 180
    q = np.stack([noisy, blob])
    gts = [[[1, 1, 8, 8]]] * 2
    gt, gv = _gt(gts, max_g=1)
    hits, peak, fb = _both_hits(q, gt, gv, max_runs=4)
    assert fb.tolist() == [True, False]
    _host_vs_device(q[1:], gts[1:], hits[1:], peak[1:],
                    np.arange(0.0, 1.0, 0.05))


def test_sweep_batch_takes_every_transfer_dtype():
    rng = np.random.default_rng(4)
    cam = rng.random((3, 12, 14)).astype(np.float32) ** 2
    gt, gv = _gt([[[1, 2, 8, 9]], [[0, 0, 13, 11]], [[4, 4, 6, 7]]])
    want = jsweep.sweep_batch(jnp.asarray(cam), gt, gv, SIGMAS)
    for transfer in ("float32", "uint16", "uint8"):
        packed = pack_cams(torch.from_numpy(cam), transfer)
        got = device_sweep.sweep_batch(packed, gt, gv, SIGMAS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=transfer)


def test_all_256_levels_round_trip():
    k = np.arange(256, dtype=np.float32)
    cam = torch.from_numpy((k / np.float32(255.0)).reshape(1, 16, 16))
    u16 = pack_cams(cam, "uint16")
    u8 = pack_cams(cam, "uint8")
    assert u16.dtype == torch.uint16 and u8.dtype == torch.uint8
    np.testing.assert_array_equal(u16.numpy().ravel(), k * 257)
    for packed in (cam, u16, u8):
        np.testing.assert_array_equal(
            device_sweep.render_uint8(packed).numpy().ravel(), k)
        deq = dequantize_cams_np(packed.numpy())
        np.testing.assert_array_equal(deq, cam.numpy())
        # the host protocol's rendering of the unpacked CAM
        np.testing.assert_array_equal((deq * 255.0).astype(np.uint8).ravel(),
                                      k)
    np.testing.assert_array_equal(
        device_sweep.render_uint8(cam).numpy(),
        np.asarray(jsweep.render_uint8(jnp.asarray(cam.numpy()))))
    assert device_sweep.render_uint8(u8) is u8


def test_device_eval_counters_match_jax():
    rng = np.random.default_rng(6)
    b, h, w = 5, 20, 24
    yy, xx = np.mgrid[0:h, 0:w]
    cams = np.stack([np.exp(-((yy - rng.uniform(4, 16)) ** 2
                              + (xx - rng.uniform(4, 20)) ** 2)
                            / (2 * rng.uniform(2, 6) ** 2))
                     for _ in range(b)]).astype(np.float32)
    cams[1] = np.maximum(cams[1], 0.7 * cams[0][:, ::-1])   # two blobs
    cams[4] = 0.0                                           # empty
    gt = rng.integers(0, 10, (b, 3, 4)).astype(np.float32)
    gt[..., 2:] += 8
    gv = rng.random((b, 3)) < 0.7
    gv[:, 0] = True
    taus = np.arange(0.0, 1.0, 0.01).astype(np.float32)
    sigmas = np.asarray([0.3, 0.5, 0.7], np.float32)
    got = device_eval.batch_counters(*(torch.from_numpy(np.asarray(v))
                                       for v in (cams, gt, gv, taus,
                                                 sigmas)))
    want = jdevice_eval.batch_counters(*(jnp.asarray(v) for v in
                                         (cams, gt, gv, taus, sigmas)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        device_eval.max_box_acc(got, torch.tensor(float(b))).numpy(),
        np.asarray(jdevice_eval.max_box_acc(want, jnp.float32(b))))


# ------------------------------------------------------- the evaluator
def _result_equal(a: dict, b: dict) -> None:
    for k in _SCALARS:
        assert a[k] == b[k], (k, a[k], b[k])
    assert a["best_tau"] == b["best_tau"]
    for s in (30, 50, 70):
        np.testing.assert_array_equal(a["curves"][s], b["curves"][s])
        np.testing.assert_array_equal(a["curves"]["top1"][s],
                                      b["curves"]["top1"][s])
        np.testing.assert_array_equal(a["curves"]["top5"][s],
                                      b["curves"]["top5"][s])


@pytest.fixture(scope="module")
def knob_runs(val_split):  # noqa: F811
    """The transplanted small UnetTCAM over the 24 val images under each
    knob; the device cache's second pass counts the pipeline's epochs."""
    targs, jargs = _args()
    variables = jax_variables(jax_model(), seed=5)
    model = torch_model(variables)
    base = targs.replace(eval_pipeline_depth=1)
    out = {}

    def run(name, args, ev=None):
        ev = ev or _evaluators(val_split, model, jax_model(), args, jargs)[0]
        out[name] = (ev.run(), ev)
        return ev

    run("base", base)
    for transfer in ("uint16", "uint8"):
        run(transfer, base.replace(eval_transfer=transfer))
    run("depth8", base.replace(eval_pipeline_depth=8))
    run("device_sweep", base.replace(eval_sweep="device"))
    run("device_sweep_uint16", base.replace(eval_sweep="device",
                                            eval_transfer="uint16"))
    cache = base.replace(eval_device_cache=True, eval_pipeline_depth=8)
    ev = run("cache_record", cache)
    calls = {"n": 0}
    orig = ev.pipe.epoch

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    ev.pipe.epoch = counting
    out["cache_recorded"] = ev.pipe in evaluator._DEVICE_EVAL_CACHE
    run("cache_replay", cache, ev=ev)
    out["cache_epochs"] = calls["n"]
    ev0 = run("cache_zero", cache.replace(eval_device_cache_mb=0))
    out["cache_zero_recorded"] = ev0.pipe in evaluator._DEVICE_EVAL_CACHE
    return out


@pytest.mark.parametrize("name", ["uint16", "uint8", "depth8",
                                  "device_sweep", "device_sweep_uint16",
                                  "cache_record", "cache_replay",
                                  "cache_zero"])
def test_evaluator_counters_identical_across_knobs(knob_runs, name):
    base = knob_runs["base"][0]
    assert base["n_images"] == 24 and base["timing"]["sweep"] == "host"
    res = knob_runs[name][0]
    _result_equal(res, base)
    if name.startswith("device_sweep"):
        assert res["timing"]["sweep"] == "device"
        assert res["sweep_fallbacks"] >= 0
    if name == "cache_replay":
        assert res["timing"]["device_cache"] == "replayed"
        assert knob_runs["cache_epochs"] == 0
    if name == "cache_record":
        assert res["timing"]["device_cache"] == "recorded"
        assert knob_runs["cache_recorded"]
    if name == "cache_zero":
        assert res["timing"]["device_cache"] == "over_budget"
        assert not knob_runs["cache_zero_recorded"]


def test_device_sweep_and_on_device_match_jax_on_injected_cams(val_split):  # noqa: F811
    """eval_sweep=device and on_device_eval, both evaluators given the
    same CAMs (a function of the bit-equal batch): equal outputs."""
    targs, jargs = _args()

    def fake(images, raw=None, targets=None, generator=None):
        cam = (images[..., 0] * 0.125 + 0.5).clamp(0.0, 1.0)
        return cam, images[:, 0, :10, 0]

    def jfake(params, bstats, images, targets, key, raw=None):
        cam = jnp.clip(images[..., 0] * 0.125 + 0.5, 0.0, 1.0)
        return cam, images[:, 0, :10, 0]

    for knob in (dict(eval_sweep="device"), dict(on_device_eval=True)):
        t = targs.replace(**knob)
        j = jargs.replace(**knob)
        ev, jev = _evaluators(val_split, torch.nn.Identity(), jax_model(),
                              t, j)
        ev.eval_step = fake
        jev.eval_step = jfake
        # JAX's CamEvaluator takes on_device from its caller (the trainer
        # and cli/evaluate pass args.on_device_eval)
        jev.on_device = bool(t.on_device_eval)
        res = ev.run()
        jres = jev.run({"params": {}, "batch_stats": {}},
                       jax.random.PRNGKey(0))
        keys = (("maxboxacc_30", "maxboxacc_50", "maxboxacc_70",
                 "localization", "classification", "n_images")
                if "on_device_eval" in knob else _SCALARS)
        for k in keys:
            assert res[k] == pytest.approx(jres[k], rel=0, abs=1e-4), k
        if "eval_sweep" in knob:
            assert ev.use_dev_sweep and jev.use_dev_sweep
            assert res["sweep_fallbacks"] == jres["sweep_fallbacks"]
            assert res["best_tau"] == jres["best_tau"]
