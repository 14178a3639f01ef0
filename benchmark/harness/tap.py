"""What the timed path's first steps hand the reference.

StepTap stands in for the trainer's train_step callable during the
warm-up epoch, which set-up drives through Trainer.train_epoch as the
window does.  For the steps the train state counts as 0, 1 and 2 it copies
into buffers allocated at the first (never captured) call: the batch the
step
receives, the seeder's Gumbel noise, the step's returned terms, the
optimizer's momentum after step 1 (the first gradient as the optimizer
got it: g + wd p0) and the parameters after step 3.  The copies are
device copies, so a CUDA graph that captures the steps (the chunked route)
captures them too.  Where the step would
draw its seeder noise from its generator (the per-step route), the tap
draws it from that generator with the recipe's formula and passes it in,
so both sides get the same noise.  A graph is replayed for every chunk of
its length, so under capture each copy is made only where a device
counter, bumped by the graph's step 0, reads 1: in the first replay.
(The chunked route's eager warm-up call, which it undoes, copies
nothing.)  Disarmed, it only forwards the call.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference.seeder import gumbel_noise

STEPS = 3


def _cam_side(batch: dict) -> Optional[torch.Tensor]:
    for k in ("std_cam", "std_cam_u16", "roi"):
        if batch.get(k) is not None:
            return batch[k]
    return None


class StepTap:
    def __init__(self, trainer, needs_seeds: bool):
        self.inner = trainer.train_step
        self.trainer = trainer
        self.needs_seeds = needs_seeds
        self.armed = True
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.gumbels: List[torch.Tensor] = []
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.momentum: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.calls = 0
        self.replays = None
        trainer.train_step = self

    def _put(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if self.capturing:
            dst.copy_(torch.where(self.replays == 1, src.detach(), dst))
        else:
            dst.copy_(src.detach())

    def __call__(self, state, batch, switches, seed_weighted,
                 generator=None, gumbel=None, student=None,
                 dropout_generator=None):
        i = state.step
        if not self.armed or i >= STEPS:
            return self.inner(state, batch, switches,
                              seed_weighted=seed_weighted,
                              generator=generator, gumbel=gumbel,
                              student=student,
                              dropout_generator=dropout_generator)
        self.calls += 1
        self.capturing = (batch["label"].is_cuda
                          and torch.cuda.is_current_stream_capturing())
        if self.needs_seeds and gumbel is None:
            cam = _cam_side(batch)
            b, h, w = cam.shape
            gumbel = gumbel_noise((b, 2, h * w), generator, cam.device)
        if not self.batches:
            self.batches = [{k: v.clone() for k, v in batch.items()
                             if isinstance(v, torch.Tensor)}
                            for _ in range(STEPS)]
            if gumbel is not None:
                self.gumbels = [gumbel.clone() for _ in range(STEPS)]
        if self.replays is None:
            self.replays = torch.zeros((), dtype=torch.int32,
                                       device=batch["label"].device)
        warm_up = (batch["label"].is_cuda and not self.capturing
                   and getattr(self.trainer, "_chunk_runner", None)
                   is not None)
        if self.capturing and i == 0:
            self.replays += 1
        if not warm_up:
            for k, v in self.batches[i].items():
                self._put(v, batch[k])
            if gumbel is not None:
                self._put(self.gumbels[i], gumbel)
        out = self.inner(state, batch, switches, seed_weighted=seed_weighted,
                         generator=generator, gumbel=gumbel, student=student,
                         dropout_generator=dropout_generator)
        if not self.metrics:
            self.metrics = [{k: v.detach().clone() for k, v in out.items()}
                            for _ in range(STEPS)]
        model, opt = state.model, state.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        if i == 0 and not self.momentum:
            self.momentum = {names[id(p)]: torch.empty_like(p)
                             for p, st in opt.state.items()
                             if st.get("momentum_buffer") is not None}
            self.params = {n: torch.empty_like(p)
                           for n, p in model.named_parameters()}
        if warm_up:
            return out
        for k, v in self.metrics[i].items():
            self._put(v, out[k])
        if i == 0:
            for p, st in opt.state.items():
                self._put(self.momentum[names[id(p)]], st["momentum_buffer"])
        if i == STEPS - 1:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    self._put(self.params[n], p)
        return out

    def release(self) -> dict:
        """Disarms the tap and hands over the copies, on the host."""
        self.armed = False
        self.trainer.train_step = self.inner

        def host(d):
            return {k: v.detach().cpu() for k, v in d.items()}
        return {"batches": [host(b) for b in self.batches],
                "gumbels": [g.cpu() for g in self.gumbels],
                "metrics": [{k: float(v) for k, v in m.items()}
                            for m in self.metrics],
                "momentum": host(self.momentum),
                "params": host(self.params), "calls": self.calls}
