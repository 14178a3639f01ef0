"""The process mesh over torch.distributed (port of parallel/mesh.py).

One process per device, as the JAX package's multi-process branch with one
local device per process.  The world's ranks form a (dp, mp) grid with
rank = d mp + m (JAX's reshape(dp, mp) of the device list):
- dp shards the batch: `batch_size` is per rank, the global batch is
  batch_size x dp, its rows in the order of d.  Every rank of one d
  reads the same data shard (shard_index d of dp).
- mp shards the classification head's fc over classes (state_sharding's
  one rule): each rank of a dp index holds its slice of the classes, its
  logits slice is all-gathered over the mp group (ClassShardedLinear).
  Every other parameter is replicated.

What a global program sees whole is made global by hand: BatchNorm's
statistics (parallel/sync_bn.py), the loss denominators that count
something in the batch (losses/core.MasterLoss.compute_global), the
gradients (all_reduce_grads, summed over the dp group), the random draws
of the batch (global_draw: each rank draws the global batch's noise and
keeps its rows) and the eval counters (psum_across).

The trainer and the evaluate CLI make the run's mesh and pass it to the
steps and the evaluator.  A train step runs under `use(mesh)`, within
which the modules that JAX's global program lets see the whole batch
(BatchNorm, the seeders' and dropout's draws) read it.  Without a mesh,
or with one rank, every route is the single-device one, bit for bit.

Launch: `python -m torch.distributed.run --nproc_per_node N -m
tcam_wsol_video_tpu_torch.cli.train ...`; maybe_init_distributed reads
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), takes cuda:LOCAL_RANK and joins over NCCL on the card,
over gloo under --device cpu.  Nothing falls back to another backend.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

DP = "dp"
MP = "mp"
# seconds a collective (and the rendezvous) may wait before the run fails
DEFAULT_TIMEOUT_S = 600
# the gradient all-reduce's bucket size in elements (fp32: 64 MiB)
GRAD_BUCKET_ELEMS = 16 << 20


def world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def is_master() -> bool:
    """Rank 0 (or no process group): the one process that writes files."""
    return rank() == 0


def maybe_init_distributed(device="cuda", backend: Optional[str] = None,
                           timeout_s: Optional[float] = None
                           ) -> torch.device:
    """Joins the process group when launched by torchrun (WORLD_SIZE set);
    returns the rank's device.  A CUDA device becomes cuda:LOCAL_RANK.
    backend: nccl for CUDA, gloo for the CPU, unless given (two ranks on
    one card must ask for gloo: NCCL refuses them).  timeout_s (default
    TCAM_DIST_TIMEOUT_S or 600): the rendezvous' and every collective's
    deadline.  Without WORLD_SIZE, or with the group already joined, only
    the device is resolved."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to "
                               "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build")
    if timeout_s is None:
        timeout_s = float(os.environ.get("TCAM_DIST_TIMEOUT_S",
                                         DEFAULT_TIMEOUT_S))
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return device


def shutdown() -> None:
    """Leaves the process group (an entry point's last act)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class Mesh:
    """This rank's place in the (dp, mp) grid, and its two groups: the dp
    group (the ranks of its m, one per data shard) and the mp group (the
    ranks of its d, one per class slice).  A group is None when it holds
    this rank alone."""
    dp: int
    mp: int
    rank: int = 0
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None
    # the process group's backend ("" without one)
    backend: str = ""
    # a core.clock.SpanClock that times the gradient all-reduce when set
    clock: Optional[object] = None

    def __deepcopy__(self, memo) -> "Mesh":
        # one per process: a copied model (the student) shares it
        return self

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def d(self) -> int:
        return self.rank // self.mp

    @property
    def m(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> dict:
        return {DP: self.dp, MP: self.mp}

    def comm_device(self, device: torch.device) -> torch.device:
        """Where a collective's tensor lives: the card under NCCL, the CPU
        under gloo for a host value."""
        return device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh of the world (JAX make_mesh): dp -1 takes
    world // mp; dp mp must equal the world size, else ValueError.  With
    more than one rank every rank must call it (it makes the groups)."""
    world = world_size()
    if mp < 1:
        raise ValueError(f"mesh_mp must be >= 1, got {mp}")
    if dp == -1:
        dp = world // mp
    if dp < 1 or dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} != {world} ranks")
    mesh = Mesh(dp=dp, mp=mp, rank=rank())
    if dist.is_available() and dist.is_initialized():
        mesh.backend = dist.get_backend()
    if world == 1:
        return mesh
    grid = np.arange(world).reshape(dp, mp)
    # every rank creates every group, in one order
    for m in range(mp):
        g = dist.new_group(grid[:, m].tolist()) if dp > 1 else None
        if m == mesh.m:
            mesh.dp_group = g
    for d in range(dp):
        g = dist.new_group(grid[d, :].tolist()) if mp > 1 else None
        if d == mesh.d:
            mesh.mp_group = g
    return mesh


# the mesh of the train step running now (use), else None
_CURRENT: List[Optional[Mesh]] = [None]


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Within: BatchNorm in training mode normalizes over the mesh's dp
    group and the batch's draws are the rank's rows of the global draw
    (the single-device routes without a mesh or with one rank)."""
    prev = _CURRENT[0]
    _CURRENT[0] = mesh if mesh is not None and mesh.world > 1 else None
    try:
        yield
    finally:
        _CURRENT[0] = prev


def within(mesh: Optional[Mesh], fn):
    """fn run under use(mesh) at each call (a train step); fn itself
    without a mesh or with one rank."""
    if mesh is None or mesh.world == 1:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with use(mesh):
            return fn(*args, **kwargs)
    return run


def current_dp_group() -> Optional[object]:
    """The dp group of the mesh in use, None without one (or with dp 1)."""
    mesh = _CURRENT[0]
    return None if mesh is None else mesh.dp_group


# ---------------------------------------------------------- batch rows
def global_rows(b: int) -> Tuple[int, int]:
    """(global batch, this rank's first row) for a per-rank batch of b
    under the mesh in use; (b, 0) without one."""
    mesh = _CURRENT[0]
    if mesh is None or mesh.dp == 1:
        return b, 0
    return b * mesh.dp, mesh.d * b


def global_draw(draw, shape, **kw) -> torch.Tensor:
    """draw(shape, **kw) (torch.rand, torch.randn) as the global batch's
    draw, of which this rank keeps its rows: the noise of a row does not
    depend on the number of ranks (JAX draws over the global array).
    shape[0] is the per-rank batch."""
    shape = tuple(shape)
    gb, r0 = global_rows(shape[0])
    if gb == shape[0]:
        return draw(shape, **kw)
    return draw((gb,) + shape[1:], **kw)[r0:r0 + shape[0]]


# ---------------------------------------------------------- reductions
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (nothing for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def psum_across(x, mesh: Optional[Mesh] = None, device=None):
    """Sums a value over the dp group (the data shards), each shard once:
    numpy arrays and Python numbers come back as such (summed in float64
    on the card under NCCL, on the CPU under gloo), tensors as tensors.
    The identity without a mesh or with one shard."""
    if mesh is None or mesh.dp_group is None:
        return x
    if isinstance(x, torch.Tensor):
        return all_reduce_(x.clone(), mesh.dp_group)
    arr = np.asarray(x, np.float64)
    dev = mesh.comm_device(torch.device(device or "cuda"))
    t = torch.from_numpy(arr.copy()).to(dev)
    out = all_reduce_(t, mesh.dp_group).cpu().numpy()
    return out if isinstance(x, np.ndarray) else out.item()


def all_reduce_grads(params: Iterable[torch.Tensor], group,
                     bucket_elems: int = GRAD_BUCKET_ELEMS) -> None:
    """Sums the gradients over `group` in flat buckets (the DDP analogue:
    JAX's psum of the global program's gradient).  Parameters without a
    gradient are skipped; they are the same on every rank."""
    if group is None:
        return
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)
    grads = [p.grad for p in params if p.grad is not None]
    buckets: List[List[torch.Tensor]] = []
    size = bucket_elems
    for g in grads:
        if (size + g.numel() > bucket_elems or buckets[-1][0].dtype
                != g.dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel()
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)


def sync_grads(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """A train step's gradient sum over the dp group, between backward
    and the optimizer step (timed on mesh.clock when set)."""
    if mesh is None or mesh.dp_group is None:
        return
    begin = mesh.clock.start() if mesh.clock is not None else None
    all_reduce_grads(model.parameters(), mesh.dp_group)
    if mesh.clock is not None:
        mesh.clock.stop(begin)


def reduce_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """A step's scalar metrics summed over the dp group in one all-reduce
    (the loss shares into the global loss, the counts into the global
    counts), each back in its dtype."""
    if mesh is None or mesh.dp_group is None:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].reshape(()).to(torch.float64)
                        for k in keys])
    dist.all_reduce(flat, group=mesh.dp_group)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def broadcast_state(model: nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer from the first rank of its dp group
    (d = 0), the same rank for every replicated tensor: the ranks start
    from rank 0's weights, and the class slices from their own m's."""
    if mesh.world == 1:
        return
    src = mesh.m     # global rank of (0, m)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if _is_sharded(model, name):
                if mesh.dp_group is not None:
                    dist.broadcast(t.data, src=src, group=mesh.dp_group)
            else:
                dist.broadcast(t.data, src=0)


# --------------------------------------------------- the mp class head
class _CopyToMp(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    mp group (each rank's classes contribute their part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _GatherClasses(torch.autograd.Function):
    """All-gathers the class slices over the mp group along the last axis;
    the backward keeps this rank's slice (every rank of the group computes
    the same loss from the full logits)."""

    @staticmethod
    def forward(ctx, x, group, m, sizes):
        ctx.m, ctx.sizes = m, sizes
        parts = [torch.empty(x.shape[:-1] + (k,), dtype=x.dtype,
                             device=x.device) for k in sizes]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, dy):
        lo = sum(ctx.sizes[:ctx.m])
        return dy[..., lo:lo + ctx.sizes[ctx.m]].contiguous(), None, None, \
            None


def gather_classes(x: torch.Tensor, mesh: Mesh, sizes: List[int]
                   ) -> torch.Tensor:
    return _GatherClasses.apply(x, mesh.mp_group, mesh.m, sizes)


class ClassShardedLinear(nn.Module):
    """The head's fc with this rank's slice of the classes (rows
    [lo, hi) of the (K, C) weight and of the bias).  forward gives the full
    logits (its slice all-gathered over the mp group).  state_dict holds
    the full weight and bias (gathered: every rank of the mp group must
    call it), and load_state_dict takes the full ones and keeps its slice,
    so a snapshot does not depend on the layout."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        k = full.out_features
        if k % mesh.mp:
            # JAX's device_put refuses a class axis that mp does not divide
            raise ValueError(
                f"mesh_mp {mesh.mp} does not divide the {k} classes of the "
                "classification head's fc")
        self.mesh = mesh
        self.sizes = [k // mesh.mp] * mesh.mp
        self.lo = mesh.m * self.sizes[0]
        self.hi = self.lo + self.sizes[0]
        self.in_features, self.out_features = full.in_features, k
        self.weight = nn.Parameter(full.weight.detach()[self.lo:self.hi]
                                   .clone())
        self.bias = nn.Parameter(full.bias.detach()[self.lo:self.hi].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToMp.apply(x, self.mesh.mp_group)
        y = F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        return gather_classes(y, self.mesh, self.sizes)

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """A slice-shaped tensor (the weight, the bias, their momentum)
        gathered over the mp group into its full shape."""
        parts = [torch.empty((k,) + t.shape[1:], dtype=t.dtype,
                             device=t.device) for k in self.sizes]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=self.mesh.mp_group)
        return torch.cat(parts, 0)

    @property
    def full_weight(self) -> torch.Tensor:
        return self.full(self.weight)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "weight"] = self.full(self.weight)
        destination[prefix + "bias"] = self.full(self.bias)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        for name in ("weight", "bias"):
            key = prefix + name
            if key not in state_dict:
                missing_keys.append(key)
                continue
            src = state_dict[key]
            if src.shape[0] != self.out_features:
                error_msgs.append(f"{key}: {tuple(src.shape)} is not the "
                                  f"full head of {self.out_features}")
                continue
            with torch.no_grad():
                getattr(self, name).copy_(src[self.lo:self.hi])


def fc_weight(head: nn.Module) -> torch.Tensor:
    """The full (K, C) weight of a head's fc, gathered when sharded."""
    fc = head.fc
    return fc.full_weight if isinstance(fc, ClassShardedLinear) \
        else fc.weight


def _is_sharded(model: nn.Module, name: str) -> bool:
    head = getattr(model, "classification_head", None)
    return (name.startswith("classification_head.fc.")
            and head is not None
            and isinstance(getattr(head, "fc", None), ClassShardedLinear))


def state_sharding(model: nn.Module, mesh: Mesh) -> nn.Module:
    """JAX state_sharding's rule on a port model, in place: with mp > 1
    the classification head's fc (WGAP's; a head without one shards
    nothing) holds this rank's class slice, every other parameter stays
    replicated.  Returns the model."""
    head = getattr(model, "classification_head", None)
    fc = getattr(head, "fc", None)
    if mesh.mp > 1 and isinstance(fc, nn.Linear):
        head.fc = ClassShardedLinear(fc, mesh).to(fc.weight.device)
    return model


def sharded_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that hold a class slice (in the model's order)."""
    return [p for n, p in model.named_parameters() if _is_sharded(model, n)]


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: nn.Module) -> dict:
    """optimizer.state_dict() with the momentum of the class slices
    gathered to the full head (a collective of the mp group)."""
    sd = optimizer.state_dict()
    sharded = {id(p) for p in sharded_params(model)}
    if not sharded:
        return sd
    fc = model.classification_head.fc
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    state = dict(sd["state"])
    for p in sharded_params(model):
        i = index[id(p)]
        st = state.get(i)
        if st is not None and st.get("momentum_buffer") is not None:
            state[i] = {**st, "momentum_buffer": fc.full(
                st["momentum_buffer"])}
    return {**sd, "state": state}


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: nn.Module, sd: dict) -> None:
    """The inverse of full_optimizer_state: the full head's momentum
    sliced to this rank's classes, then loaded."""
    params = sharded_params(model)
    if params:
        fc = model.classification_head.fc
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        state = dict(sd["state"])
        for p in params:
            st = state.get(index[id(p)])
            if st is not None and st.get("momentum_buffer") is not None:
                state[index[id(p)]] = {
                    **st, "momentum_buffer":
                    st["momentum_buffer"][fc.lo:fc.hi]}
        sd = {**sd, "state": state}
    optimizer.load_state_dict(sd)
