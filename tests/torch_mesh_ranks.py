"""The rank bodies of tests/test_torch_mesh*.py: each runs in a spawned
process joined over gloo (tests/torch_dist.py) and returns numpy.  No
JAX here; the models are built as tests/torch_port_fixtures.py builds
them, from flax variables given as numpy."""
import os

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.models.classifier import (DenseBoxNet,
                                                         STDClassifier)
from tcam_wsol_video_tpu_torch.models.resnet import (BatchNorm2d, ResNetWSOL,
                                                     frozen_statistics)
from tcam_wsol_video_tpu_torch.models.transplant import load_flax_variables
from tcam_wsol_video_tpu_torch.models.unet import UnetTCAM
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh

LAYERS = (1, 1, 1, 1)
CLASSES = 10


def _np_state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _rows(x, mesh, b):
    return x[mesh.d * b:(mesh.d + 1) * b]


# ------------------------------------------------------------- mesh rules
def mesh_rules(rank, world):
    """make_mesh's -1 rule, its refusals and the grid of 4 ranks."""
    out = {}
    m = pmesh.make_mesh(-1, 2)
    out["dp_mp"] = (m.dp, m.mp, m.d, m.m)
    for dp, mp in ((3, 1), (-1, 3), (2, 1), (1, 0)):
        try:
            pmesh.make_mesh(dp, mp)
            out[(dp, mp)] = "ok"
        except ValueError as e:
            out[(dp, mp)] = str(e)
    # a dp group sum reaches the ranks of this rank's m only
    out["psum"] = float(pmesh.psum_across(float(rank + 1), m))
    with pmesh.use(m):
        out["rows"] = pmesh.global_rows(3)
    out["rows_after"] = pmesh.global_rows(3)
    return out


# ------------------------------------------------------------- global BN
def global_bn(rank, world, cases):
    """Each case: a BatchNorm2d over this rank's rows of x (NCHW) in
    training mode, the gradient of sum(y cot) summed over the ranks as a
    train step sums it, and the running statistics; then one forward
    under frozen_statistics, which must leave them as they are."""
    mesh = pmesh.make_mesh(world, 1)
    outs = []
    for case in cases:
        dtype = getattr(torch, case["dtype"])
        b = case["x"].shape[0] // world
        bn = BatchNorm2d(case["x"].shape[1], eps=case["eps"]).to(dtype)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(case["w"]))
            bn.bias.copy_(torch.from_numpy(case["b"]))
        x = torch.from_numpy(_rows(case["x"], mesh, b)).requires_grad_(True)
        with pmesh.use(mesh):
            y = bn(x)
            (y * torch.from_numpy(_rows(case["cot"], mesh, b))).sum(
            ).backward()
            pmesh.all_reduce_grads(bn.parameters(), mesh.dp_group)
            stats = (bn.running_mean.clone(), bn.running_var.clone())
            with frozen_statistics():
                bn(x)
        outs.append({
            "y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": stats[0].numpy(), "var": stats[1].numpy(),
            "frozen_kept": bool(torch.equal(stats[0], bn.running_mean)
                                and torch.equal(stats[1], bn.running_var)),
            "tracked": int(bn.num_batches_tracked)})
    return outs


# --------------------------------------------------------------- steps
def tcam_step(rank, world, targs, variables, batch, gumbel, draw_seed):
    """One TCAM train step of the rank's rows of the global batch (its
    rows of the injected Gumbel noise); and the rank's rows of a Gumbel
    draw from a seeded generator (parallel/mesh.global_draw)."""
    from tcam_wsol_video_tpu_torch.cams.seeding import (gumbel_noise,
                                                        seeder_cfg_from_args)
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    mesh = pmesh.make_mesh(targs.mesh_dp, targs.mesh_mp)
    model = UnetTCAM(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES,
                     freeze_cl=bool(targs.freeze_cl))
    load_flax_variables(model, variables)
    pmesh.state_sharding(model, mesh)
    state = TrainState(model, build_optimizer(targs, model, targs.lr),
                       targs.elb_init_t)
    ml = get_loss_tcam(targs)
    b = batch["label"].shape[0] // mesh.dp
    local = {k: torch.from_numpy(_rows(v, mesh, b)) for k, v in batch.items()}
    local["label"] = local["label"].long()
    met = make_train_step(ml, targs, seeder_cfg_from_args(targs),
                          mesh=mesh)(
        state, local, ml.switches(0), True,
        gumbel=torch.from_numpy(_rows(gumbel, mesh, b)))
    with pmesh.use(mesh):
        drawn = gumbel_noise((b, 2, 16), torch.Generator().manual_seed(
            draw_seed), "cpu")
    return {"metrics": {k: float(v) for k, v in met.items()},
            "state": _np_state(model), "drawn": drawn.numpy()}


def cbox_step(rank, world, targs, boxnet_vars, cls_vars, priors, batch,
              noise):
    """One C_BOX train step of the rank's rows (and rows of the injected
    noise); returns the global metrics and the new state."""
    from tcam_wsol_video_tpu_torch.cams.seeding import \
        cbox_seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.engine import cbox_steps
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.losses.build import get_loss
    mesh = pmesh.make_mesh(targs.mesh_dp, 1)
    model = DenseBoxNet(ResNetWSOL(layers=LAYERS))
    load_flax_variables(model, boxnet_vars)
    cls = STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES)
    load_flax_variables(cls, cls_vars)
    cls.requires_grad_(False)
    state = TrainState(model, build_optimizer(targs, model, targs.lr),
                       targs.elb_init_t)
    ml = get_loss(targs)
    b = batch["label"].shape[0] // mesh.dp
    local = {k: torch.from_numpy(_rows(v, mesh, b)) for k, v in batch.items()}
    met = cbox_steps.make_cbox_train_step(
        ml, targs, cbox_seeder_cfg_from_args(targs), cls, priors,
        mesh=mesh)(
        state, local, ml.switches(0),
        noise={k: torch.from_numpy(_rows(v, mesh, b))
               for k, v in noise.items()})
    return {"metrics": {k: float(v) for k, v in met.items()},
            "state": _np_state(model)}


# ------------------------------------------------------------- trainer
def std_cl_trainer(rank, world, targs, variables, synth, n_epochs):
    """The STD_CL Trainer on the rank's shards (dp index of mesh_dp,
    mesh_mp): val at the initial weights, n_epochs epochs with their val
    passes; returns the records and the final state (full head)."""
    from tcam_wsol_video_tpu_torch.cli.train import build_data
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    mesh = pmesh.make_mesh(targs.mesh_dp, targs.mesh_mp)
    kc = KeyChain(targs.seed)
    args, train_pipe, eval_pipes = build_data(
        targs.replace(data_root=os.path.dirname(synth["data_root"]),
                      metadata_root=synth["metadata_root"]), kc, "cpu",
        mesh)
    model = STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES)
    load_flax_variables(model, variables)
    tr = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                 device="cpu", mesh=mesh)
    evals = [tr.evaluate(0, "val")]
    train = []
    for ep in range(n_epochs):
        train.append(tr.train_epoch(ep))
        evals.append(tr.evaluate(ep + 1, "val"))
    keys = ("classification", "localization", "n_images", "maxboxacc_30",
            "maxboxacc_50", "maxboxacc_70")
    out = {"evals": [{k: r[k] for k in keys} for r in evals],
           "train": [{k: r[k] for k in ("loss", "classification", "n",
                                        "steps")} for r in train],
           "fc_rows": tuple(model.classification_head.fc.weight.shape),
           "state": _np_state(model)}
    if mesh.world > 1:
        out["resumed"] = _resume_check(tr, args, train_pipe, eval_pipes, kc,
                                       variables, mesh)
    return out


def _resume_check(tr, args, train_pipe, eval_pipes, kc, variables, mesh):
    """A rolling checkpoint written by rank 0 (the full head and its
    momentum, gathered by every rank), loaded by a fresh trainer on the
    same mesh: its parameters and momentum equal the trained one's."""
    import torch.distributed as dist
    from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    tr._save_checkpoint()
    dist.barrier()
    _, payload = ckpt.find_last_checkpoint(tr.outd)
    model = STDClassifier(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES)
    load_flax_variables(model, variables)
    fresh = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                    device="cpu", mesh=mesh)
    fresh.load_checkpoint_if_any()
    mom = {id(p): st.get("momentum_buffer")
           for p, st in tr.state.optimizer.state.items()}
    params = dict(tr.model.named_parameters())
    same_params = all(torch.equal(p, params[n])
                      for n, p in fresh.model.named_parameters())
    same_momentum = all(
        torch.equal(st["momentum_buffer"], mom[id(params[n])])
        for n, p in fresh.model.named_parameters()
        for st in [fresh.state.optimizer.state.get(p, {})]
        if "momentum_buffer" in st)
    fc = "classification_head.fc.weight"
    saved_fc = tuple(payload["model"][fc].shape)
    opt_state = payload["optimizer"]["state"]
    saved_mom = sorted({tuple(v["momentum_buffer"].shape)
                        for v in opt_state.values()
                        if v.get("momentum_buffer") is not None
                        and v["momentum_buffer"].dim() == 2
                        and v["momentum_buffer"].shape[1] == 2048})
    return {"same_params": same_params, "same_momentum": same_momentum,
            "saved_fc": saved_fc, "saved_fc_momentum": saved_mom,
            "step": fresh.state.step}


# ---------------------------------------------------------------- the card
def card_step(rank, world, seed, b, crop):
    """On the card (TF32 off, cuDNN deterministic): a BatchNorm2d in
    training mode over the rank's rows, then one fp32 TCAM step of the
    small UnetTCAM (encoder trained, exact CRF kernel) on the rank's rows
    of a b-frame batch, the seeder's noise the rank's rows of one global
    draw.  world 1 without a process group is the reference."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        return _card_step(world, seed, b, crop)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _card_step(world, seed, b, crop):
    from tcam_wsol_video_tpu_torch.cams.roi import roi_one_cam_np
    from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
    from tcam_wsol_video_tpu_torch.core.config import stage2_tcam_recipe
    from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer
    from tcam_wsol_video_tpu_torch.engine.state import TrainState
    from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
    from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral
    mesh = pmesh.make_mesh(world, 1)
    dev = torch.device("cuda", torch.cuda.current_device())
    lb = b // world
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 8, 12, 12)).astype(
        np.float32) * 2.0 + 0.5)
    bn = BatchNorm2d(8).to(dev)
    with pmesh.use(mesh):
        y = bn(_rows(x, mesh, lb).to(dev))
    out = {"bn_y": y.detach().cpu().numpy(),
           "bn_mean": bn.running_mean.cpu().numpy(),
           "bn_var": bn.running_var.cpu().numpy()}

    args = stage2_tcam_recipe(crop_size=crop, batch_size=lb, freeze_cl=False,
                              compute_dtype="float32")
    torch.manual_seed(seed)
    model = UnetTCAM(ResNetWSOL(layers=LAYERS), "WGAP", CLASSES).to(dev)
    pmesh.broadcast_state(model, mesh)
    state = TrainState(model, build_optimizer(args, model, args.lr),
                       args.elb_init_t)
    ml = get_loss_tcam(args)
    cam = rng.random((b, crop, crop)).astype(np.float32) ** 2
    batch = {
        "image": rng.standard_normal((b, crop, crop, 3)).astype(np.float32),
        "raw_img": (rng.random((b, crop, crop, 3)) * 255).astype(np.float32),
        "label": rng.integers(0, CLASSES, b).astype(np.int64),
        "std_cam": cam,
        "roi": np.stack([roi_one_cam_np(c)[0] for c in cam]).astype(
            np.int32),
        "msk_bbox": np.ones((b, crop, crop), np.float32)}
    local = {k: torch.from_numpy(_rows(v, mesh, lb)).to(dev)
             for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    bilateral.counts.reset()
    met = make_train_step(ml, args, seeder_cfg_from_args(args),
                          mesh=mesh)(
        state, local, ml.switches(0), True, generator=gen)
    torch.cuda.synchronize()
    out.update(metrics={k: float(v) for k, v in met.items()},
               state=_np_state(model), launches=bilateral.counts.kernel)
    return out


def nvjpeg_repeat(rank, world, paths, rounds):
    """The card's image route (nvjpeg_loader.load_batch: the frames
    decoded one after another on a side stream, no sync between them)
    `rounds` times while the card is kept busy, against each frame loaded
    alone with a sync after it: the number of batches that differ."""
    from tcam_wsol_video_tpu_torch.data import nvjpeg_loader
    n = len(paths)
    zeros = [0] * n
    ref = []
    for p in paths:
        ref.append(nvjpeg_loader.load_batch([p], 64, 64, [0], [0], [0])[1])
        torch.cuda.synchronize()
    ref = torch.cat(ref)
    hog = torch.randn((4096, 4096), device="cuda")
    bad = 0
    for _ in range(rounds):
        for _ in range(4):
            hog = hog @ hog.T / 4096.0
        raw = nvjpeg_loader.load_batch(paths, 64, 64, zeros, zeros, zeros)[1]
        bad += int(not torch.equal(raw, ref))
    return bad
