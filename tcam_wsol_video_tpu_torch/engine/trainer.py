"""Training engine of the TCAM task: epoch loop, evaluation, model
selection and checkpoints (port of engine/trainer.py, TCAM path).

Each epoch: DecayTemp takes the epoch before the batches (it sets the
dataset's CAM heat and whether seeds are weighted), the loss switches and
the learning rate are those of the epoch; the train step runs once per
pipeline batch; after the last batch the ELB t anneals, and the epoch's
checkpoint holds the annealed t.  Validation after each epoch updates the
best-localization and best-classification snapshots; `fit` ends with a
test evaluation at each.

The host loop records per epoch the time blocked on the pipeline (data
wait) and each step's time: on a CUDA device the span between CUDA events
recorded before and after the step, on the CPU the host clock.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.seeding import seeder_cfg_from_args
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import experiment_tag
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.engine.evaluator import CamEvaluator
from tcam_wsol_video_tpu_torch.engine.lr import build_lr_fn
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer, set_lr
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss_tcam
from tcam_wsol_video_tpu_torch.losses.elb import update_t


class PerformanceMeter:
    """A metric's history and its best value."""

    def __init__(self, higher_is_better: bool = True):
        self.higher = higher_is_better
        self.history: List[float] = []
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def update(self, value: float, epoch: int) -> bool:
        self.history.append(float(value))
        better = (self.best_value is None
                  or (value > self.best_value if self.higher
                      else value < self.best_value))
        if better:
            self.best_value = float(value)
            self.best_epoch = int(epoch)
        return better


class _StepClock:
    """Per-step times without a host sync on the card: CUDA events around
    each step, read at the end of the epoch."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, begin) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((begin, e))
        else:
            self.marks.append((begin, time.perf_counter()))

    def millis(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


class Trainer:
    def __init__(self, args, model, train_pipe, eval_pipes: Dict[str, tuple],
                 keychain: Optional[KeyChain] = None, device="cuda"):
        """eval_pipes: {split: (dataset, pipeline)}."""
        if args.task != constants.TCAM:
            raise NotImplementedError(f"only the TCAM trainer is ported "
                                      f"(got {args.task})")
        self.args = args
        self.model = model
        self.device = torch.device(device)
        self.train_pipe = train_pipe
        self.eval_pipes = eval_pipes
        self.kc = keychain or KeyChain(args.seed)

        self.master_loss = get_loss_tcam(args)
        self.lr_fn = build_lr_fn(args)
        optimizer = build_optimizer(args, model, self.lr_fn(0))
        self.state = TrainState(model, optimizer, elb_t=args.elb_init_t)
        self.train_step = make_train_step(self.master_loss, args,
                                          seeder_cfg_from_args(args))
        self.decay_temp = DecayTemp(
            sl_tc_knn_t=args.sl_tc_knn_t, sl_tc_min_t=args.sl_tc_min_t,
            sl_tc_knn=args.sl_tc_knn, sl_tc_knn_mode=args.sl_tc_knn_mode,
            sl_tc_knn_epoch_switch_uniform=(
                args.sl_tc_knn_epoch_switch_uniform),
            sl_tc_seed_tech=args.sl_tc_seed_tech)
        if train_pipe.ds.decay_temp is None:
            train_pipe.ds.decay_temp = self.decay_temp

        self.meters = {
            "val_localization": PerformanceMeter(True),
            "val_classification": PerformanceMeter(True),
            "train_loss": PerformanceMeter(False),
            "train_classification": PerformanceMeter(True),
        }
        self.best_loc_state: Optional[dict] = None
        self.best_cl_state: Optional[dict] = None
        self.records: Dict[str, list] = {"train": [], "eval": []}
        self.outd = os.path.join(args.outd, experiment_tag(args),
                                 args.exp_id)
        os.makedirs(self.outd, exist_ok=True)
        self.logger = ExpLogger(self.outd)

    # -------------------------------------------------------------- train
    def _save_checkpoint(self) -> None:
        ckpt.save_checkpoint(self.outd, self.state)
        ckpt.keep_last_n_checkpoints(self.outd,
                                     self.args.keep_last_n_checkpoints)
        self.save_meters()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        args = self.args
        self.decay_temp.set_epoch(epoch)
        seed_weighted = self.decay_temp.seed_tech == constants.SEED_WEIGHTED
        switches = self.master_loss.switches(epoch)
        self.state.epoch = epoch
        set_lr(self.state.optimizer, self.lr_fn(epoch))

        zero = torch.zeros((), device=self.device)
        tot_loss, n_corr, n = zero.clone(), zero.clone(), zero.clone()
        clock = _StepClock(self.device)
        wait_ms: List[float] = []
        t_epoch = time.perf_counter()
        batches = iter(self.train_pipe.epoch(epoch))
        i = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            wait_ms.append((time.perf_counter() - t0) * 1e3)
            if batch is None:
                break
            dev_batch = {k: v for k, v in batch.items() if k != "image_id"}
            gen = self.kc.key("train", epoch, i, device=self.device)
            begin = clock.start()
            metrics = self.train_step(self.state, dev_batch, switches,
                                      seed_weighted=seed_weighted,
                                      generator=gen)
            clock.stop(begin)
            tot_loss += metrics["loss"]
            n_corr += metrics["n_correct"]
            n += metrics["n"]
            i += 1
            if (args.checkpoint_save > 0
                    and self.state.step % args.checkpoint_save == 0):
                self._save_checkpoint()
            if args.log_every and i % args.log_every == 0:
                self.logger.log({"split": "train", "epoch": epoch, "it": i,
                                 "loss": float(metrics["loss"])},
                                step=self.state.step)
        step_ms = clock.millis()
        wall_ms = (time.perf_counter() - t_epoch) * 1e3

        # epoch end: ELB anneal, then a checkpoint holding the annealed t
        self.state.elb_t = update_t(self.state.elb_t, args.elb_mulcoef,
                                    args.elb_max_t)
        if args.checkpoint_save > 0:
            self._save_checkpoint()
        out = {
            "epoch": epoch,
            "loss": float(tot_loss) / max(1, i),
            "classification": 100.0 * float(n_corr) / max(1.0, float(n)),
            "n": int(n), "steps": i, "wall_ms": wall_ms,
            "median_step_ms": float(np.median(step_ms)) if step_ms else 0.0,
            "step_ms": step_ms,
            # the last wait is the end of the epoch, not a step's
            "data_wait_ms_per_step": float(np.mean(wait_ms[:-1]))
            if i else 0.0,
            # the host's share of it: pixels, then the CAM side
            **{f"data_{k}_per_step": float(np.mean(v)) if v else 0.0
               for k, v in self.train_pipe.timing.items()},
            "elb_t": self.state.elb_t, "lr": self.lr_fn(epoch),
            "heat_t": self.decay_temp.t, "seed_weighted": seed_weighted,
        }
        self.meters["train_loss"].update(out["loss"], epoch)
        self.meters["train_classification"].update(out["classification"],
                                                   epoch)
        self.records["train"].append(out)
        self.logger.log({"split": "train", **{
            k: v for k, v in out.items() if k != "step_ms"}},
            step=self.state.step)
        return out

    # --------------------------------------------------------------- eval
    def evaluate(self, epoch: int, split: str, snapshot: str = "") -> Dict:
        """One pass over `split`; `snapshot` names the weights in the
        record (the test passes at the best snapshots)."""
        ds, pipe = self.eval_pipes[split]
        res = CamEvaluator(self.model, self.args, ds, pipe, split,
                           fast=self.args.fast_eval).run()
        rec = {"split": split, "epoch": epoch, "snapshot": snapshot,
               **{k: v for k, v in res.items()
                  if isinstance(v, (int, float))}, **res["timing"]}
        self.records["eval"].append(rec)
        self.logger.log(rec, step=self.state.step)
        return res

    def _snapshot(self, tag: str, epoch: int, metric: str,
                  value: float) -> dict:
        snap = {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}
        ckpt.save_best_model(
            os.path.join(self.outd, tag), self.state.step, self.model,
            extra={"epoch": epoch, "elb_t": self.state.elb_t,
                   metric: value})
        return snap

    def model_selection(self, epoch: int, val_res: Dict) -> None:
        """Snapshots at the best validation localization and
        classification."""
        if self.meters["val_localization"].update(val_res["localization"],
                                                  epoch):
            self.best_loc_state = self._snapshot(
                constants.BEST_LOC, epoch, "localization",
                val_res["localization"])
        if self.meters["val_classification"].update(
                val_res["classification"], epoch):
            self.best_cl_state = self._snapshot(
                constants.BEST_CL, epoch, "classification",
                val_res["classification"])

    # ------------------------------------------------------------ resume
    def _meters_path(self) -> str:
        return os.path.join(self.outd, "meters.json")

    def save_meters(self) -> None:
        payload = {k: {"history": m.history, "best_value": m.best_value,
                       "best_epoch": m.best_epoch}
                   for k, m in self.meters.items()}
        with open(self._meters_path(), "w") as f:
            json.dump(payload, f)

    def load_meters(self) -> None:
        if not os.path.isfile(self._meters_path()):
            return
        with open(self._meters_path()) as f:
            payload = json.load(f)
        for k, d in payload.items():
            if k in self.meters:
                self.meters[k].history = d["history"]
                self.meters[k].best_value = d["best_value"]
                self.meters[k].best_epoch = d["best_epoch"]

    def load_checkpoint_if_any(self) -> int:
        """Restores the last rolling checkpoint, the meters and the best
        snapshots; returns the epoch to start from."""
        step, payload = ckpt.find_last_checkpoint(self.outd)
        if payload is None:
            return 0
        ckpt.restore_checkpoint(self.state, payload)
        self.load_meters()
        for tag, attr in ((constants.BEST_LOC, "best_loc_state"),
                          (constants.BEST_CL, "best_cl_state")):
            _, best = ckpt.load_best_model(os.path.join(self.outd, tag))
            if best is not None:
                setattr(self, attr, {
                    f"{comp}.{k}": v.to(self.device)
                    for comp, sd in best["components"].items()
                    for k, v in sd.items()})
        self.logger.log(f"resumed from step {step}")
        return self.state.epoch + 1

    # ---------------------------------------------------------------- fit
    def fit(self) -> Dict[str, Dict]:
        """Validation before training and after each epoch, then the test
        split at the best-localization and best-classification
        snapshots."""
        start = self.load_checkpoint_if_any()
        self.model_selection(start, self.evaluate(start,
                                                  constants.VALIDSET))
        for epoch in range(start, self.args.max_epochs):
            self.train_epoch(epoch)
            self.model_selection(epoch, self.evaluate(epoch,
                                                      constants.VALIDSET))
        results = {}
        current = {k: v.detach().clone()
                   for k, v in self.model.state_dict().items()}
        for tag, snap in ((constants.BEST_LOC, self.best_loc_state),
                          (constants.BEST_CL, self.best_cl_state)):
            if snap is None:
                continue
            self.model.load_state_dict(snap)
            results[tag] = self.evaluate(self.args.max_epochs,
                                         constants.TESTSET, snapshot=tag)
        self.model.load_state_dict(current)
        self.dump_performances(results)
        return results

    def dump_performances(self, results: Dict) -> None:
        """Meters, per-epoch records and the final test results."""
        payload = {
            "meters": {k: {"history": m.history, "best": m.best_value,
                           "best_epoch": m.best_epoch}
                       for k, m in self.meters.items()},
            "records": self.records,
            "test": {tag: {k: v for k, v in r.items()
                           if isinstance(v, (int, float, list))}
                     for tag, r in results.items()}}
        with open(os.path.join(self.outd, "performances.json"), "w") as f:
            json.dump(payload, f, indent=1)
