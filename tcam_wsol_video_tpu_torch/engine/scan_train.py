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
What a graph bakes in is fixed for an epoch (the learning rate, ELB t,
loss switches, seed technique, CAM heat): each epoch captures its graphs
anew, one for K steps and one for a shorter tail chunk (JAX retraces for
the tail).

Before the first capture one eager iteration warms the libraries up (the
kernels' builds, cuBLAS/cuDNN handles, the momentum buffers and gradients
the captured step updates in place); the train state is then put back as
it was, so the warm-up trains nothing.  A capture that fails raises:
nothing retries eagerly.  A kernel wrapper counts its launches when the
graph captures it; the counts are taken back after the capture and added
once per replay (ops/cuda/build.COUNTERS).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.seeding import gumbel_noise
from tcam_wsol_video_tpu_torch.core import constants
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
    noise or None (no seeds); dropout_generators: k generators or Nones."""

    def run_chunk(state: TrainState, frames_pool, cams_pool, plan: dict,
                  gumbel: Optional[torch.Tensor], dropout_generators: list,
                  switches, seed_weighted: bool, t_heat: float,
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
        (state.step already advanced by k).  Returns the epoch's record:
        steps, per-step metrics (device tensors), the chunk spans (CUDA
        events on the card, the host clock on the CPU), the host's ms to
        enqueue each chunk (the first replay of a graph uploads it), the
        host ms of each capture (the warm-up in the first), and the plan's
        host ms."""
        feed = self.feed
        t0 = time.perf_counter()
        plan, all_ids, t_heat = feed.epoch_plan(epoch, subset)
        n = len(all_ids)
        rec = {"steps": n, "metrics": [], "chunk_ms": [], "chunk_k": [],
               "enqueue_ms": [], "capture_ms": [], "plan_ms": 0.0}
        if n == 0:
            return rec
        dev_plan = {k: to_device(v, self.device) for k, v in plan.items()}
        rec["plan_ms"] = (time.perf_counter() - t0) * 1e3
        b = plan["rows"].shape[1]
        c = feed.c
        self._static = {k: v[:self.chunk].clone() for k, v in
                        dev_plan.items()}
        self._gumbel = (torch.zeros((self.chunk, b, 2, c * c),
                                    device=self.device)
                        if self.needs_seeds else None)
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(self.chunk)]
        graphs: Dict[int, tuple] = {}
        done = 0
        while done < n:
            k = min(self.chunk, n - done)
            if self.cuda and k not in graphs:
                # the warm-up runs on the chunk's inputs; the fill below
                # seeds the generators again after it
                t_cap = time.perf_counter()
                self._fill(dev_plan, done, k, keychain, epoch, key_offset)
                graphs[k] = self._capture(state, k, switches, seed_weighted,
                                          t_heat)
                rec["capture_ms"].append((time.perf_counter() - t_cap) * 1e3)
            t_host = time.perf_counter()
            self._fill(dev_plan, done, k, keychain, epoch, key_offset)
            if self.cuda:
                begin = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                begin.record()
                metrics = self._replay(state, graphs[k], k)
                end.record()
                rec["chunk_ms"].append((begin, end))
            else:
                t_run = time.perf_counter()
                metrics = self._eager(state, k, switches, seed_weighted,
                                      t_heat)
                rec["chunk_ms"].append((time.perf_counter() - t_run) * 1e3)
            rec["enqueue_ms"].append((time.perf_counter() - t_host) * 1e3)
            rec["chunk_k"].append(k)
            rec["metrics"] += metrics
            if on_chunk is not None:
                on_chunk(done, k, metrics)
            done += k
        if self.cuda:
            torch.cuda.synchronize(self.device)
            rec["chunk_ms"] = [a.elapsed_time(e) for a, e in rec["chunk_ms"]]
        del graphs
        return rec

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
        return (runner or self.run_chunk)(
            state, feed.frames_pool, feed.cams_pool, self._static,
            self._gumbel, self._gens[:k], switches, seed_weighted, t_heat, k)

    def _eager(self, state, k, switches, seed_weighted, t_heat):
        """The CPU's chunk: k eager iterations, each assembly timed."""
        feed = self.feed

        def timed(*a):
            t0 = time.perf_counter()
            out = feed.assemble(*a)
            feed.timing["assembly_ms"].append((time.perf_counter() - t0)
                                              * 1e3)
            return out

        return self._call(state, k, switches, seed_weighted, t_heat,
                          make_chunk_runner(timed, self.train_step))

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
        gen_before = self._gens[0].get_state()
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
        torch.cuda.synchronize(self.device)
        self._warm = True

    def _capture(self, state, k, switches, seed_weighted, t_heat) -> tuple:
        """A CUDA graph of k steps on the static inputs.  Returns (graph,
        its output metrics, each counter's launches in one replay)."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if not self._warm:
            self._warm_up(state, switches, seed_weighted, t_heat, stream)
        graph = torch.cuda.CUDAGraph()
        if self._live_dropout:
            for g in self._gens[:k]:
                graph.register_generator_state(g)
        step, before = state.step, [c.kernel for c in COUNTERS]
        try:
            with torch.cuda.graph(graph, stream=stream):
                metrics = self._call(state, k, switches, seed_weighted,
                                     t_heat)
            per_replay = [c.kernel - b for c, b in zip(COUNTERS, before)]
        finally:
            # the capture ran nothing: the step count and the launch
            # counts are those before it
            for c, b in zip(COUNTERS, before):
                c.kernel = b
            state.step = step
        self.captures += 1
        return graph, metrics, per_replay

    def _replay(self, state, captured, k) -> List[dict]:
        graph, metrics, per_replay = captured
        graph.replay()
        for c, n in zip(COUNTERS, per_replay):
            c.kernel += n
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
