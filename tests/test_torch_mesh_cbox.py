"""One C_BOX train step on 2 ranks (spawned, gloo; tests/torch_dist.py)
against JAX's C_BOX step under a mesh_dp=2 mesh on the same global batch
(test_torch_cbox.py's batch, weights and noise), and against the port's
own step on one rank.  Some frames' trained boxes are invalid and rank
1's two CAMs are constant, so the ranks hold unequal valid boxes and
seeded pixels: the masked ELB means and the seed CE divide by the global
counts.  Tolerances: test_torch_cbox.py's (the encoder's update within
JAX's own fp32 gap) and test_torch_mesh_step.py's against one rank.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist import Ranks
import torch_mesh_ranks as ranks
from torch_port_fixtures import (CROP, assert_close, jax_classifier,
                                 jax_variables, torch_classifier)
from tcam_wsol_video_tpu.cams.seeding import CBoxSeederCfg as JCBoxCfg
from tcam_wsol_video_tpu.engine import cbox_steps as jcbox_steps
from tcam_wsol_video_tpu.engine.optim import build_optimizer as jbuild_opt
from tcam_wsol_video_tpu.engine.state import TrainState as JState
from tcam_wsol_video_tpu.losses.build import get_loss as jget_loss
from tcam_wsol_video_tpu.models.classifier import DenseBoxNet as JDenseBoxNet
from tcam_wsol_video_tpu.models.resnet import ResNetWSOL as JResNetWSOL
from tcam_wsol_video_tpu_torch.cams.seeding import (cbox_seeder,
                                                    cbox_seeder_cfg_from_args)
from tcam_wsol_video_tpu_torch.engine import cbox_steps
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict
from tcam_wsol_video_tpu_torch.ops.box_stats import box_stats
from test_torch_cbox import (PRIORS, _step_args, _step_batch, _torch_boxnet,
                             boxnet_variables, jax_cbox_noise)
from test_torch_mesh_step import (B, DELTA_RTOL, DELTA_RTOL_1, LOSS_RTOL,
                                  LOSS_RTOL_1, WORLD, _check_updates,
                                  _jax_mesh, _shard)

torch.set_num_threads(1)

# C_BOX's encoder update: JAX's own fp32 gap (test_torch_cbox.py)
ENC_DELTA_RTOL = 1e-1


@pytest.fixture(scope="module")
def cbox():
    targs, jargs = _step_args()
    targs = targs.replace(batch_size=B // WORLD)
    boxnet = boxnet_variables()
    cls_vars = jax_variables(jax_classifier(), seed=13)
    batch = _step_batch(14)
    key = jax.random.PRNGKey(15)
    scfg = JCBoxCfg(n=targs.cb_seed_n, fg_erode_k=targs.cb_seed_erode_k,
                    fg_erode_iter=targs.cb_seed_erode_iter,
                    ksz=targs.cb_seed_ksz)
    k_seed, k_rand = jax.random.split(key)
    gumbel, z = jax_cbox_noise(k_seed, B, CROP * CROP, scfg)
    noise = {"normal": np.asarray(jax.random.normal(k_rand, (B,))),
             "gumbel": gumbel, "z": z}
    group = Ranks(ranks.cbox_step, WORLD, targs.replace(mesh_dp=WORLD),
                  boxnet, cls_vars, PRIORS, batch, noise)

    jm = JDenseBoxNet(encoder=JResNetWSOL(layers=(1, 1, 1, 1)))
    jml = jget_loss(jargs)
    opt = jbuild_opt(jargs, boxnet["params"], lambda e: jargs.lr)
    mesh = _jax_mesh()
    rep = NamedSharding(mesh, P())
    jstate = jax.device_put(JState.create(boxnet, opt.init(boxnet["params"]),
                                          jargs.elb_init_t), rep)
    new_jstate, jmet = jcbox_steps.make_cbox_train_step(
        jm, jax_classifier(), jml, opt, jargs, scfg,
        size_priors_min_s=PRIORS)(
        jstate, _shard(mesh, batch), jml.switches(0), key,
        jax.device_put(cls_vars["params"], rep),
        jax.device_put(cls_vars["batch_stats"], rep))

    # the port on one rank; each rank's valid boxes and seeded pixels
    tm = _torch_boxnet(boxnet)
    tcls = torch_classifier(cls_vars).requires_grad_(False)
    tml = get_loss(targs)
    tnoise = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = cbox_steps.make_cbox_train_step(
        tml, targs, cbox_seeder_cfg_from_args(targs), tcls, PRIORS)(
        TrainState(tm, build_optimizer(targs, tm, targs.lr),
                   targs.elb_init_t), tbatch, tml.switches(0), noise=tnoise)
    probe = _torch_boxnet(boxnet).train()
    with torch.no_grad():
        valid = box_stats(probe(tbatch["image"])["box"], CROP, CROP,
                          targs.cb_scale_domain)[2]
    seeds = cbox_seeder(tbatch["std_cam"], cbox_seeder_cfg_from_args(targs),
                        gumbel=tnoise["gumbel"], z=tnoise["z"])
    seeded = ((seeds != targs.seg_ignore_idx)
              & (valid.reshape(-1, 1, 1) > 0)).reshape(WORLD, -1).sum(1)
    return dict(variables=boxnet, jstate=new_jstate, jmet=jmet, one=one,
                one_state={k: v.numpy() for k, v in tm.state_dict().items()},
                valid=valid.reshape(WORLD, -1).sum(1).tolist(),
                seeded=seeded.tolist(), ranks=group.join())


CBOX_TERMS = ("loss", "area_box", "cl_scoring", "seed_cbox", "box_bounds")


def test_cbox_step_with_unequal_counts_matches_jax_mesh(cbox):
    assert cbox["valid"][0] != cbox["valid"][1], cbox["valid"]
    assert cbox["seeded"][0] != cbox["seeded"][1], cbox["seeded"]
    for k in CBOX_TERMS:
        for r in cbox["ranks"]:
            assert_close(r["metrics"][k], cbox["jmet"][k], LOSS_RTOL, k)
    for k in ("n_correct", "n", "valid_boxes"):
        for r in cbox["ranks"]:
            assert int(r["metrics"][k]) == int(cbox["jmet"][k]), k
    old = flax_to_state_dict(cbox["variables"])
    new = flax_to_state_dict({"params": cbox["jstate"].params,
                              "batch_stats": cbox["jstate"].batch_stats})
    _check_updates(old, new, [r["state"] for r in cbox["ranks"]],
                   DELTA_RTOL, enc_rtol=ENC_DELTA_RTOL)


def test_cbox_step_on_two_ranks_matches_one_rank(cbox):
    for k in CBOX_TERMS:
        assert_close(cbox["ranks"][0]["metrics"][k], float(cbox["one"][k]),
                     LOSS_RTOL_1, k)
    old = flax_to_state_dict(cbox["variables"])
    _check_updates(old, cbox["one_state"],
                   [r["state"] for r in cbox["ranks"]], DELTA_RTOL_1)
