"""One TCAM train step on 2 ranks (spawned, gloo; tests/torch_dist.py)
against JAX's step under a mesh_dp=2 mesh on the same global batch, and
against the port's own step on one rank (C_BOX's:
test_torch_mesh_cbox.py).

The ranks take rows [r b, (r + 1) b) of the global batch and of the
noise JAX's step draws for it (its per-frame key splits), as the port's
ranks take their rows of one global draw.
- TCAM on the exact CRF (its plain version on the CPU) and on the
  landmark CRF (the production recipe).  One of rank 1's CAMs is
  constant, so it seeds nothing and the ranks hold unequal seed counts:
  the self-learning CE divides by the global count.
Compared: the loss terms, every parameter's update and the BN statistics
(the tolerances of the one-device parity tests, test_torch_step.py and
test_torch_cbox.py; also JAX's own mesh test's 5e-4 on the parameters),
the two ranks' states bit-equal, and the rank's rows of a seeded Gumbel
draw equal to the world-1 draw's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torch_dist import Ranks
import torch_mesh_ranks as ranks
from torch_port_fixtures import (CROP, assert_close, jax_model,
                                 jax_variables, torch_model)
from tcam_wsol_video_tpu.cams.seeding import TCAMSeederCfg as JCfg
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.engine.steps import make_train_step as jstep
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
from tcam_wsol_video_tpu_torch.cams.seeding import (gumbel_noise,
                                                    seeder_cfg_from_args,
                                                    tcam_seeder)
from tcam_wsol_video_tpu_torch.core.config import (stage2_tcam_production,
                                                   stage2_tcam_recipe)
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict
from test_torch_seeding import jax_gumbel
from test_torch_step import _jax_args

torch.set_num_threads(1)

# against JAX (test_torch_step.py's and test_torch_cbox.py's bounds)
LOSS_RTOL = 1e-4
DELTA_RTOL = 2e-3
DELTA_ULPS = 4
STATE_RTOL = 1e-4
# JAX's mesh test (tests/test_trainer_mesh.py) on the new parameters
PARAM_ATOL = 5e-4
# 2 ranks against the port's one rank on the same batch: fp32 sums over
# the global batch taken per rank, then across the two
LOSS_RTOL_1 = 1e-5
DELTA_RTOL_1 = 1e-4
B = 4
WORLD = 2


def _jax_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))


def _shard(mesh, batch):
    return jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                          NamedSharding(mesh, P("dp")))


def _tcam_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cam = rng.random((B, CROP, CROP)).astype(np.float32) ** 2
    cam[3] = 0.5        # rank 1's second frame: constant, seeds nothing
    roi = np.stack([roi_one_cam_np(c)[0] for c in cam])
    return {
        "image": rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32),
        "raw_img": (rng.random((B, CROP, CROP, 3)) * 255).astype(np.float32),
        "label": rng.integers(0, 10, B).astype(np.int32),
        "std_cam": cam, "roi": roi.astype(np.int32),
        "msk_bbox": np.ones((B, CROP, CROP), np.float32)}


def _check_updates(old, new_want, got_states, delta_rtol, enc_rtol=None):
    for k, want in new_want.items():
        got = got_states[0][k]
        for other in got_states[1:]:
            np.testing.assert_array_equal(other[k], got, k)
        if "running_" in k:
            assert_close(got, want, STATE_RTOL, k)
            continue
        if k not in old:                   # num_batches_tracked
            np.testing.assert_array_equal(got, want, k)
            continue
        d_got, d_want = got - old[k], want - old[k]
        if np.abs(d_want).max() == 0:      # zero and frozen (freeze_cl)
            assert np.abs(d_got).max() == 0, k
            continue
        enc_gap = enc_rtol is not None and k.startswith("encoder.")
        rtol = enc_rtol if enc_gap else delta_rtol
        tol = (rtol * np.abs(d_want).max()
               + DELTA_ULPS * np.finfo(np.float32).eps * np.abs(old[k]).max())
        assert np.abs(d_got - d_want).max() <= tol, k
        if not enc_gap:
            assert np.abs(got - want).max() <= PARAM_ATOL, k


# ------------------------------------------------------------------ TCAM
def _tcam(targs) -> dict:
    args = _jax_args(targs)
    jm = jax_model(freeze_cl=True)
    variables = jax_variables(jm, seed=1)
    batch = _tcam_batch(2)
    key = jax.random.PRNGKey(9)
    k_seed, _ = jax.random.split(key)
    gumbel = jax_gumbel(k_seed, B, CROP * CROP)
    group = Ranks(ranks.tcam_step, WORLD, targs.replace(mesh_dp=WORLD),
                  variables, batch, gumbel, 5)

    ml = jget_loss(args)
    opt = jbuild_opt(args, variables["params"], lambda e: args.lr)
    mesh = _jax_mesh()
    jstate = jax.device_put(
        JState.create(variables, opt.init(variables["params"]),
                      args.elb_init_t), NamedSharding(mesh, P()))
    scfg = JCfg(seed_tech=args.sl_tc_seed_tech, min_=args.sl_tc_min,
                max_=args.sl_tc_max, min_p=args.sl_tc_min_p,
                max_p=args.sl_tc_max_p, ksz=args.sl_tc_ksz,
                use_roi=args.sl_tc_use_roi)
    new_jstate, jmet = jstep(jm, ml, opt, args, scfg)(
        jstate, _shard(mesh, batch), ml.switches(0), key, jnp.float32(1.0))

    # the port on one rank, and the seeds each rank draws
    tm = torch_model(variables, freeze_cl=True)
    tml = get_loss_tcam(targs)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["label"] = tbatch["label"].long()
    one = make_train_step(tml, targs, seeder_cfg_from_args(targs))(
        TrainState(tm, build_optimizer(targs, tm, targs.lr),
                   targs.elb_init_t), tbatch, tml.switches(0), True,
        gumbel=torch.from_numpy(gumbel))
    seeds = tcam_seeder(tbatch["std_cam"], seeder_cfg_from_args(targs),
                        roi=tbatch["roi"], seed_tech=targs.sl_tc_seed_tech,
                        gumbel=torch.from_numpy(gumbel))
    seeded = (seeds != targs.seg_ignore_idx).reshape(WORLD, -1).sum(1)
    return dict(variables=variables, jstate=new_jstate, jmet=jmet,
                one=one, one_state={k: v.numpy() for k, v in
                                    tm.state_dict().items()},
                seeded=seeded.tolist(), ranks=group.join())


@pytest.fixture(scope="module", params=["exact", "landmarks"])
def tcam(request):
    if request.param == "exact":
        targs = stage2_tcam_recipe(crop_size=CROP, batch_size=B // WORLD,
                                   compute_dtype="float32")
    else:
        targs = stage2_tcam_production(crop_size=CROP, batch_size=B // WORLD,
                                       crf_n_landmarks=256,
                                       compute_dtype="float32")
    return _tcam(targs)


TCAM_TERMS = ("loss", "self_learning_tcams", "con_ran_field_tcams",
              "max_size_positive_tcams")


def test_tcam_step_on_two_ranks_matches_jax_mesh(tcam):
    # the ranks held unequal seed counts (the constant CAM seeds nothing)
    assert tcam["seeded"][0] != tcam["seeded"][1], tcam["seeded"]
    for k in TCAM_TERMS:
        want = float(tcam["jmet"][k])
        for r in tcam["ranks"]:
            got = r["metrics"][k]
            assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
    for r in tcam["ranks"]:
        assert r["metrics"]["n"] == B
    old = flax_to_state_dict(tcam["variables"])
    new = flax_to_state_dict({"params": tcam["jstate"].params,
                              "batch_stats": tcam["jstate"].batch_stats})
    _check_updates(old, new, [r["state"] for r in tcam["ranks"]],
                   DELTA_RTOL)


def test_tcam_step_on_two_ranks_matches_one_rank(tcam):
    for k in TCAM_TERMS:
        want = float(tcam["one"][k])
        got = tcam["ranks"][0]["metrics"][k]
        assert abs(got - want) <= LOSS_RTOL_1 * abs(want), (k, got, want)
    old = flax_to_state_dict(tcam["variables"])
    _check_updates(old, tcam["one_state"],
                   [r["state"] for r in tcam["ranks"]], DELTA_RTOL_1)


def test_global_draw_rows_equal_the_world1_draw(tcam):
    want = gumbel_noise((B, 2, 16), torch.Generator().manual_seed(5),
                        "cpu").numpy()
    b = B // WORLD
    for r, out in enumerate(tcam["ranks"]):
        np.testing.assert_array_equal(out["drawn"], want[r * b:(r + 1) * b])
