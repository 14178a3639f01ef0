"""K train steps a dispatch over the card-resident feed (port of
engine/scan_train.py; train_dispatch_chunk).

The feed's per-step batch assembly is about a hundred small torch ops and
the train step some thousands: on the card the host's enqueue of them,
not the device, sets the pace of a step.  Here an epoch's sampling plan
is uploaded once (data/device_feed.DeviceTrainFeed.epoch_plan, which also
makes every frame the epoch touches resident first), and a chunk of K
steps, each assembling its batch from the pools and running the train
step (make_chunk_runner), is one dispatch:
- on the CPU, K eager iterations of assemble then step;
- on the card, one replay of a torch.cuda.CUDAGraph that captured the K
  iterations.  The plan rows, the seeder's Gumbel noise and the dropout
  seeds of the chunk are written into the graph's static inputs first.

The streams are the per-step route's: step i's seeder noise is the first
draw of KeyChain("train", epoch, i), as the train step would draw it,
and its dropout masks come from KeyChain("dropout", epoch, i) (a graph
registers a generator per step slot and seeds it before each replay).

A graph is kept for the run.  The values that change from epoch to epoch
are read from device memory: the runner owns 0-d fp32 tensors for each
param group's learning rate, ELB's t and the CAM heat, fills them with
the epoch's values before its first dispatch, and the steps it builds
read them (the optimizer's groups and the train state hold them while a
chunk is captured or run eagerly; engine/optim.DecayAllSGD, losses/elb,
data/device_feed.make_assemble).  What still changes the program is a
graph's key (program_key): the chunk length, the shapes and dtypes of the
plan's static inputs, the loss switches, the seed technique and whether
the heat is on.  An epoch first frees the kept graphs whose keys its
chunks do not need (stale_graphs), then replays the kept ones and
captures the others: one graph of K steps and one of a shorter tail
chunk (JAX retraces for the tail).  The static inputs (plan rows, seeder
noise, dropout generators) keep their addresses for the run.

Before the first capture one eager iteration warms the libraries up (the
kernels' builds, cuBLAS/cuDNN handles, the momentum buffers and gradients
the captured step updates in place); the train state is then put back as
it was, so the warm-up trains nothing.  A capture that fails raises:
nothing retries eagerly.  A kernel wrapper counts its launches when the
graph captures it; the counts are taken back after the capture and added
once per replay (ops/cuda/build.COUNTERS), and so are the recorder's
counters made inside the captured steps (core/clock.TRACE, e.g. the
landmark filter's crf.knm_builds), so that they count steps run, not
captures.  A device counter (TRACE.tally) needs none of that: its add is
in the graph.  The eager warm-up puts both back as they were.

On core/clock.TRACE an epoch records the spans data.wait (the plan, the
pool fill and the plan's upload), dispatch.release (stale graphs freed,
at a key change), dispatch.capture (a graph's capture, its chunk's
inputs filled first), dispatch.warmup (the eager warm-up inside the
first capture), dispatch.replay (a chunk's dispatch: its inputs filled,
then the replay on the card or the K eager steps on the CPU, whose
assemblies are feed.assemble) and epoch.sync (the wait for the device at
the end), the device gaps between consecutive chunks (device.gap, from
the chunks' SpanClock marks), and on the card the counters
dispatch.captures (graphs captured) and dispatch.kept (chunks replayed
on a graph kept from an earlier epoch).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.seeding import gumbel_noise
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import TRACE, SpanClock
from tcam_wsol_video_tpu_torch.data.transforms import to_device
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.ops.cuda.build import COUNTERS

# plan entries the assembly takes before the heat (then the thresholds),
# and those that ride into the batch
_ASSEMBLE_KEYS = ("rows", "cam_rows", "cam_valid", "ys", "xs", "flips")
_BATCH_KEYS = ("label", "seq_iter", "frm_iter", "valid")


def make_chunk_runner(assemble, train_step):
    """Returns run_chunk(state, frames_pool, cams_pool, plan, gumbel,
    dropout_generators, switches, seed_weighted, t_heat, k) -> the k
    steps' metrics dicts.  plan: {name: (>= k, target[, T]) tensor} on the
    pools' device, row j the j-th step's; gumbel: (>= k, B, 2, P) seeder
    noise or None (no seeds); dropout_generators: k generators or Nones;
    t_heat: the CAM heat, a float or a 0-d tensor (make_assemble)."""

    def run_chunk(state: TrainState, frames_pool, cams_pool, plan: dict,
                  gumbel: Optional[torch.Tensor], dropout_generators: list,
                  switches, seed_weighted: bool, t_heat,
                  k: int) -> List[dict]:
        out = []
        for j in range(k):
            batch = assemble(frames_pool, cams_pool,
                             *(plan[n][j] for n in _ASSEMBLE_KEYS),
                             t_heat, plan["threshs"][j])
            for n in _BATCH_KEYS:
                batch[n] = plan[n][j]
            out.append(train_step(
                state, batch, switches, seed_weighted=seed_weighted,
                gumbel=None if gumbel is None else gumbel[j],
                dropout_generator=dropout_generators[j]))
        return out

    return run_chunk


def program_key(shapes: tuple, switches, seed_weighted: bool,
                heat_on: bool) -> tuple:
    """What a captured chunk bakes in besides its length and the values
    it reads from device memory: the static inputs' (name, per-step shape,
    dtype), the loss switches, the seed technique and whether the CAM heat
    is on."""
    return (tuple(shapes), tuple(float(s) for s in switches),
            bool(seed_weighted), bool(heat_on))


def chunk_lengths(n: int, chunk: int) -> List[int]:
    """The lengths of an n-step epoch's chunks: K each, then the tail."""
    return [min(chunk, n - done) for done in range(0, n, chunk)]


def stale_graphs(kept: Iterable[tuple], needed: Iterable[tuple]
                 ) -> List[tuple]:
    """The keys (k, program_key) of the kept graphs that an epoch whose
    chunks need the keys `needed` frees before it captures: every kept
    key it does not need.  A needed key that is kept replays; one that is
    not is captured."""
    needed = set(needed)
    return [key for key in kept if key not in needed]


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step updates in place: parameters and
    buffers, gradients, and the optimizer's state."""
    ts = list(state.model.state_dict(keep_vars=True).values())
    ts += [p.grad for p in state.model.parameters() if p.grad is not None]
    for st in state.optimizer.state.values():
        ts += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return ts


class ChunkedEpochRunner:
    """Drives the train epochs of a card-resident feed K steps a dispatch.

    feed: an enabled DeviceTrainFeed; train_step: engine/steps.
    make_train_step's step (the standard one: no student, no recomputed
    CAMs); needs_seeds: whether the step draws seeder noise."""

    def __init__(self, feed, train_step, chunk_steps: int,
                 needs_seeds: bool):
        if chunk_steps < 1:
            raise ValueError(f"chunk of {chunk_steps} steps")
        self.feed = feed
        self.chunk = int(chunk_steps)
        self.needs_seeds = needs_seeds
        self.device = feed.device
        self.train_step = train_step
        self.run_chunk = make_chunk_runner(feed.assemble, train_step)
        self.cuda = self.device.type == "cuda"
        self._warm = False
        self._live_dropout = False
        # (k, program_key) -> (the epoch that captured it, _capture's tuple)
        self._graphs: Dict[tuple, tuple] = {}
        # the static inputs, made for the plan's shapes (_shapes)
        self._shapes: Optional[tuple] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._gumbel: Optional[torch.Tensor] = None
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(self.chunk)]
        # the device scalars the steps read: each group's lr, ELB's t,
        # the CAM heat
        self._lr: List[torch.Tensor] = []
        self._elb_t = torch.zeros((), device=self.device)
        self._heat = torch.zeros((), device=self.device)
        self.replays = 0
        self.captures = 0

    # ------------------------------------------------------------ epochs
    def run_epoch(self, state: TrainState, epoch: int, keychain, switches,
                  seed_weighted: bool,
                  on_chunk: Optional[Callable] = None,
                  subset: Optional[np.ndarray] = None,
                  key_offset: int = 0) -> Dict:
        """Trains one epoch (of the dataset indices `subset`, all when
        None; its step i draws the keys of step key_offset + i, so a
        bucketed epoch's keys run on across its buckets as the per-step
        loop's do).  on_chunk(offset, k, metrics) after each chunk
        (state.step already advanced by k).  Returns the epoch's steps,
        per-step metrics (device tensors) and each step's ms (its chunk's
        span over its steps: CUDA events on the card, the host clock on
        the CPU)."""
        feed = self.feed
        with TRACE.span("data.wait"):
            plan, all_ids, t_heat = feed.epoch_plan(epoch, subset)
            dev_plan = {k: to_device(v, self.device)
                        for k, v in plan.items()}
        n = len(all_ids)
        if n == 0:
            return {"steps": 0, "metrics": [], "step_ms": []}
        shapes = tuple((name, tuple(v.shape[1:]), v.dtype)
                       for name, v in dev_plan.items())
        program = program_key(shapes, switches, seed_weighted, t_heat > 0)
        needed = [(k, program) for k in chunk_lengths(n, self.chunk)]
        self.release(stale_graphs(self._graphs, needed))
        if shapes != self._shapes:
            self._make_static(dev_plan)
            self._shapes = shapes
        heat = self._set_scalars(state, t_heat)
        clock = SpanClock(self.device)
        metrics: List[dict] = []
        ks: List[int] = []
        captured = kept = 0
        done = 0
        while done < n:
            k = min(self.chunk, n - done)
            key = (k, program)
            TRACE.step = (epoch, key_offset + done)
            if self.cuda and key not in self._graphs:
                # the warm-up runs on the chunk's inputs; the fill below
                # seeds the generators again after it
                with TRACE.span("dispatch.capture"):
                    self._fill(dev_plan, done, k, keychain, epoch,
                               key_offset)
                    self._graphs[key] = (epoch, self._capture(
                        state, k, switches, seed_weighted, heat))
                captured += 1
            with TRACE.span("dispatch.replay"):
                self._fill(dev_plan, done, k, keychain, epoch, key_offset)
                begin = clock.start()
                if self.cuda:
                    made, graph = self._graphs[key]
                    kept += made != epoch
                    out = self._replay(state, graph, k)
                else:
                    out = self._eager(state, k, switches, seed_weighted,
                                      heat)
                clock.stop(begin)
            ks.append(k)
            metrics += out
            if on_chunk is not None:
                on_chunk(done, k, out)
            done += k
        TRACE.step = (epoch, None)
        if self.cuda:
            TRACE.count("dispatch.captures", captured)
            TRACE.count("dispatch.kept", kept)
        with TRACE.span("epoch.sync"):
            TRACE.fetch()
            chunk_ms = clock.millis()
        TRACE.device("device.gap", clock.gaps())
        return {"steps": n, "metrics": metrics,
                "step_ms": [ms / k for ms, k in zip(chunk_ms, ks)
                            for _ in range(k)]}

    def release(self, keys: Optional[List[tuple]] = None) -> None:
        """Frees the kept graphs of `keys` (all of them by default), with
        the memory their pools hold."""
        keys = list(self._graphs) if keys is None else keys
        if keys:
            with TRACE.span("dispatch.release"):
                for key in keys:
                    del self._graphs[key]

    def _make_static(self, dev_plan: dict) -> None:
        """The static inputs for the plan's shapes: K rows of each plan
        entry and the seeder noise of K steps."""
        self._static = {name: torch.zeros((self.chunk, *v.shape[1:]),
                                          dtype=v.dtype, device=self.device)
                        for name, v in dev_plan.items()}
        b = dev_plan["rows"].shape[1]
        c = self.feed.c
        self._gumbel = (torch.zeros((self.chunk, b, 2, c * c),
                                    device=self.device)
                        if self.needs_seeds else None)

    def _set_scalars(self, state: TrainState, t_heat: float):
        """Fills the device scalars with the epoch's values.  Returns the
        heat the chunks assemble with: the heat's scalar when it is on, 0
        otherwise."""
        groups = state.optimizer.param_groups
        if not self._lr:
            self._lr = [torch.zeros((), device=self.device) for _ in groups]
        for t, group in zip(self._lr, groups):
            t.fill_(group["lr"])
        self._elb_t.fill_(state.elb_t)
        self._heat.fill_(t_heat)
        return self._heat if t_heat > 0 else 0.0

    @contextlib.contextmanager
    def _device_scalars(self, state: TrainState):
        """The optimizer's rates and the state's ELB t swapped for the
        device scalars while the steps are built (captured, or run
        eagerly), and put back after."""
        groups = state.optimizer.param_groups
        rates, elb_t = [g["lr"] for g in groups], state.elb_t
        for group, t in zip(groups, self._lr):
            group["lr"] = t
        state.elb_t = self._elb_t
        try:
            yield
        finally:
            for group, lr in zip(groups, rates):
                group["lr"] = lr
            state.elb_t = elb_t

    def _fill(self, dev_plan, start: int, k: int, keychain,
              epoch: int, key_offset: int = 0) -> None:
        """The chunk's static inputs: its plan rows, each step's seeder
        noise (the first draw of KeyChain('train', epoch, i), as the step
        would draw it) and its dropout seed."""
        for name, v in dev_plan.items():
            self._static[name][:k].copy_(v[start:start + k])
        for j in range(k):
            i = key_offset + start + j
            if self._gumbel is not None:
                self._gumbel[j].copy_(gumbel_noise(
                    self._gumbel.shape[1:],
                    keychain.key("train", epoch, i, device=self.device),
                    self.device))
            self._gens[j].manual_seed(keychain.seed_of("dropout", epoch, i))

    def _call(self, state, k, switches, seed_weighted, t_heat,
              runner=None) -> List[dict]:
        feed = self.feed
        with self._device_scalars(state):
            return (runner or self.run_chunk)(
                state, feed.frames_pool, feed.cams_pool, self._static,
                self._gumbel, self._gens[:k], switches, seed_weighted,
                t_heat, k)

    def _eager(self, state, k, switches, seed_weighted, t_heat):
        """The CPU's chunk: k eager iterations, each assembly a span."""
        feed = self.feed

        def assemble(*a):
            with TRACE.span("feed.assemble"):
                return feed.assemble(*a)

        return self._call(state, k, switches, seed_weighted, t_heat,
                          make_chunk_runner(assemble, self.train_step))

    # ------------------------------------------------------------ graphs
    def _warm_up(self, state, switches, seed_weighted, t_heat,
                 stream) -> None:
        """One eager iteration on the capture stream, then the train state
        as it was: it builds the kernels, makes the libraries' handles,
        the gradients and the momentum buffers (zeros where the optimizer
        had none: the first update is then the same), and shows whether
        the model draws dropout masks."""
        opt = state.optimizer
        with torch.no_grad():
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    # a zero trace updates as torch's first step does
                    # (0 m + g = g)
                    if (group["momentum"] != 0 and opt.state[p].get(
                            "momentum_buffer") is None):
                        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        tensors = _state_tensors(state)
        saved = [t.detach().clone() for t in tensors]
        step, counts = state.step, [(c.kernel, c.plain) for c in COUNTERS]
        traced = TRACE.counters()
        gen_before = self._gens[0].get_state()
        # the copies above are made before the step runs
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._call(state, 1, switches, seed_weighted, t_heat)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._live_dropout = not torch.equal(gen_before,
                                             self._gens[0].get_state())
        if len(_state_tensors(state)) != len(tensors):
            raise RuntimeError("the warm-up step made train state that the "
                               "chunk runner would not restore")
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        state.step = step
        for c, (kn, pl) in zip(COUNTERS, counts):
            c.kernel, c.plain = kn, pl
        TRACE.rewind(traced)
        torch.cuda.synchronize(self.device)
        self._warm = True

    def _capture(self, state, k, switches, seed_weighted, t_heat) -> tuple:
        """A CUDA graph of k steps on the static inputs.  Returns (graph,
        its output metrics, each counter's launches in one replay, the
        recorder's counts in one replay)."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if not self._warm:
            with TRACE.span("dispatch.warmup"):
                self._warm_up(state, switches, seed_weighted, t_heat,
                              stream)
        graph = torch.cuda.CUDAGraph()
        if self._live_dropout:
            for g in self._gens[:k]:
                graph.register_generator_state(g)
        step, before = state.step, [c.kernel for c in COUNTERS]
        traced = TRACE.counters()
        counts = traced[0]
        try:
            with torch.cuda.graph(graph, stream=stream):
                metrics = self._call(state, k, switches, seed_weighted,
                                     t_heat)
            per_replay = [c.kernel - b for c, b in zip(COUNTERS, before)]
            counted = {name: n - counts.get(name, 0)
                       for name, n in TRACE.counts.items()
                       if n != counts.get(name)}
        finally:
            # the capture ran nothing: the step count and the launch
            # counts are those before it
            for c, b in zip(COUNTERS, before):
                c.kernel = b
            TRACE.rewind(traced)
            state.step = step
        self.captures += 1
        return graph, metrics, per_replay, counted

    def _replay(self, state, captured, k) -> List[dict]:
        graph, metrics, per_replay, counted = captured
        graph.replay()
        for c, n in zip(COUNTERS, per_replay):
            c.kernel += n
        for name, n in counted.items():
            TRACE.count(name, n)
        state.step += k
        self.replays += 1
        # the outputs live in the graph's pool: copies outlive the next
        # replay
        return [{name: v.clone() for name, v in m.items()} for m in metrics]


def engages(args, feed, use_student: bool, recompute_cams: bool) -> bool:
    """JAX's rule (engine/trainer.py): the chunked route runs when the
    card-resident feed is on, train_dispatch_chunk > 0, the task is not
    C_BOX, the seeds do not come from the student and the CAMs are not
    recomputed."""
    return (feed is not None
            and int(getattr(args, "train_dispatch_chunk", 0)) > 0
            and args.task != constants.C_BOX
            and not use_student and not recompute_cams)
