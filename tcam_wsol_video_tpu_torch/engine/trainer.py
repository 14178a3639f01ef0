"""Training engine of the STD_CL, F_CL and TCAM tasks: epoch loop,
evaluation, model selection and checkpoints (port of engine/trainer.py,
the paths of the three tasks).

Each epoch: for TCAM, DecayTemp takes the epoch before the batches (it
sets the dataset's CAM heat and whether seeds are weighted); the loss
switches and the learning rate are those of the epoch; the train step
runs once per pipeline batch; after the last batch the ELB t anneals (for
STD_CL too, as in the JAX trainer), and the epoch's checkpoint holds the
annealed t.  Validation after each epoch updates the
best-localization and best-classification snapshots; `fit` ends with a
test evaluation at each.

TCAM's epoch switch (sl_tc_epoch_switch_to_sl, as the JAX trainer has
it): from that epoch on, once a best-localization snapshot exists, the
steps take their seeds from the best student's own maps.  The student is
a second model on the trainer's device, loaded from that snapshot and
reloaded only when the best-localization epoch changes; each epoch's
record names its seed source (`student`, `classifier` for the seeds
recomputed without a store, `batch` for the batch's CAMs) and counts the
student's reloads.

The host loop records per epoch the time blocked on the pipeline (data
wait), the pipeline's own record of the epoch (its route, stream or the
card-resident feed, and its timings and counts: DataPipeline.epoch_stats)
and each step's time: on a CUDA device the span between CUDA events
recorded before and after the step, on the CPU the host clock; and the
host's time to enqueue a step.

The dispatch route (JAX's rule, engine/scan_train.engages): with the
card-resident feed on and train_dispatch_chunk K > 0, an epoch runs K
steps a dispatch (engine/scan_train.ChunkedEpochRunner: a CUDA graph of
K steps on the card); the student seed source and recomputed CAMs keep
the per-step loop.  Under the chunked route a step's time is its chunk's
over K, the data wait is the plan and pool fill spread over the steps,
rolling checkpoints land on chunk boundaries and the log_every records
come from the per-step losses at the epoch's end.  Each epoch record
names its `dispatch` route and K.
"""
from __future__ import annotations

import copy
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
from tcam_wsol_video_tpu_torch.core.clock import SpanClock
from tcam_wsol_video_tpu_torch.core.config import PORTED_TASKS, experiment_tag
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.engine.evaluator import CamEvaluator
from tcam_wsol_video_tpu_torch.engine.lr import build_lr_fn
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer, set_lr
from tcam_wsol_video_tpu_torch.engine import scan_train
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import make_train_step
from tcam_wsol_video_tpu_torch.losses.build import get_loss
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


class Trainer:
    def __init__(self, args, model, train_pipe, eval_pipes: Dict[str, tuple],
                 keychain: Optional[KeyChain] = None, device="cuda",
                 classifier=None):
        """eval_pipes: {split: (dataset, pipeline)}; classifier: the frozen
        stage-1 classifier, whose CAMs seed a TCAM run without a CAM
        store (the train step recomputes them, as the JAX trainer's
        _recompute_cams does)."""
        if args.task not in PORTED_TASKS:
            raise NotImplementedError(f"the {args.task} trainer is not "
                                      "ported")
        self.args = args
        self.model = model
        self.device = torch.device(device)
        self.train_pipe = train_pipe
        self.eval_pipes = eval_pipes
        self.kc = keychain or KeyChain(args.seed)

        self.master_loss = get_loss(args)
        self.lr_fn = build_lr_fn(args)
        optimizer = build_optimizer(args, model, self.lr_fn(0))
        self.state = TrainState(model, optimizer, elb_t=args.elb_init_t)
        tcam = args.task == constants.TCAM
        self._recompute_cams = (
            tcam and bool(args.sl_tc)
            and getattr(train_pipe.ds, "cam_store", None) is None
            and classifier is not None)
        # F_CL seeds with the TCAM seeder and its sl_tc_* keys, as in JAX
        self.train_step = make_train_step(
            self.master_loss, args,
            None if args.task == constants.STD_CL
            else seeder_cfg_from_args(args),
            classifier_model=classifier if self._recompute_cams else None)
        self._needs_seeds = (args.task != constants.STD_CL
                             and bool(args.sl_tc or args.sl_fc))
        self._chunk_runner: Optional[scan_train.ChunkedEpochRunner] = None
        # the epoch switch's student, built when it engages
        self._student = None
        self._student_epoch: Optional[int] = None
        self.decay_temp: Optional[DecayTemp] = None
        if tcam:
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
        self.student_reloads = 0
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

    def _student_for(self, epoch: int) -> bool:
        """Engages the epoch switch for `epoch` when it applies: (re)loads
        the student from the best-localization snapshot when its epoch
        changed (the model is copied once).  Returns whether this epoch
        seeds from the student; counts reloads."""
        sw_ep = self.args.sl_tc_epoch_switch_to_sl
        if not (self.args.task == constants.TCAM and sw_ep != -1
                and epoch >= sw_ep and self.best_loc_state is not None):
            return False
        best_epoch = self.meters["val_localization"].best_epoch
        if self._student is None or self._student_epoch != best_epoch:
            if self._student is None:
                self._student = copy.deepcopy(self.model).requires_grad_(
                    False)
            self._student.load_state_dict(self.best_loc_state)
            self._student_epoch = best_epoch
            self.student_reloads += 1
        return True

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        args = self.args
        if self.decay_temp is not None:
            self.decay_temp.set_epoch(epoch)
            seed_weighted = (self.decay_temp.seed_tech
                             == constants.SEED_WEIGHTED)
        else:
            seed_weighted = args.sl_tc_seed_tech == constants.SEED_WEIGHTED
        switches = self.master_loss.switches(epoch)
        self.state.epoch = epoch
        set_lr(self.state.optimizer, self.lr_fn(epoch))
        reloads_before = self.student_reloads
        use_student = self._student_for(epoch)
        student = self._student if use_student else None

        feed = getattr(self.train_pipe, "_device_feed", None)
        chunked = scan_train.engages(args, feed, use_student,
                                     self._recompute_cams)
        t_epoch = time.perf_counter()
        if chunked:
            run = self._run_chunked_epoch(epoch, feed, switches,
                                          seed_weighted)
        else:
            run = self._run_per_step_epoch(epoch, switches, seed_weighted,
                                           student)
        wall_ms = (time.perf_counter() - t_epoch) * 1e3
        zero = torch.zeros((), device=self.device)
        tot_loss, n_corr, n = zero.clone(), zero.clone(), zero.clone()
        terms: Dict[str, torch.Tensor] = {}
        for metrics in run["metrics"]:
            tot_loss += metrics["loss"]
            n_corr += metrics["n_correct"]
            n += metrics["n"]
            for k, v in metrics.items():
                if k not in ("loss", "n_correct", "n"):
                    terms[k] = terms.get(k, zero) + v
        i = len(run["metrics"])
        step_ms = run["step_ms"]

        # epoch end: ELB anneal, then a checkpoint holding the annealed t
        self.state.elb_t = update_t(self.state.elb_t, args.elb_mulcoef,
                                    args.elb_max_t)
        if args.checkpoint_save > 0:
            self._save_checkpoint()
        out = {
            "epoch": epoch,
            "loss": float(tot_loss) / max(1, i),
            # each loss term's mean over the epoch's steps
            "terms": {k: float(v) / max(1, i) for k, v in terms.items()},
            "classification": 100.0 * float(n_corr) / max(1.0, float(n)),
            "n": int(n), "steps": i, "wall_ms": wall_ms,
            "median_step_ms": float(np.median(step_ms)) if step_ms else 0.0,
            "step_ms": step_ms,
            "data_wait_ms_per_step": run["data_wait_ms_per_step"],
            # the host's time to enqueue a step (a chunk's over its steps)
            "host_enqueue_ms_per_step": run["enqueue_ms_per_step"],
            "dispatch": "chunked" if chunked else "per_step",
            "dispatch_chunk": int(args.train_dispatch_chunk) if chunked
            else 0,
            # the host ms of the epoch's CUDA graph captures (warm-up
            # included)
            "capture_ms": run["capture_ms"],
            # the data plane: its route; the host's pixels and CAM side,
            # the feed's assembly; cache hits and misses, pool misses and
            # decodes
            **self.train_pipe.epoch_stats(),
            "elb_t": self.state.elb_t, "lr": self.lr_fn(epoch),
            "heat_t": (self.decay_temp.t if self.decay_temp is not None
                       else 0.0),
            "seed_weighted": seed_weighted,
            "seed_source": ("student" if use_student else "classifier"
                            if self._recompute_cams else "batch"),
            "student_epoch": self._student_epoch if use_student else None,
            "student_reloads": self.student_reloads - reloads_before,
        }
        self.meters["train_loss"].update(out["loss"], epoch)
        self.meters["train_classification"].update(out["classification"],
                                                   epoch)
        self.records["train"].append(out)
        self.logger.log({"split": "train", **{
            k: v for k, v in out.items() if k != "step_ms"}},
            step=self.state.step)
        return out

    def _run_per_step_epoch(self, epoch: int, switches, seed_weighted: bool,
                            student) -> dict:
        """One step a dispatch over the pipeline's batches.  Returns the
        per-step metrics, step ms (CUDA events on the card), the mean data
        wait and the host's enqueue ms a step."""
        args = self.args
        clock = SpanClock(self.device)
        wait_ms: List[float] = []
        enqueue_ms: List[float] = []
        out: List[dict] = []
        batches = iter(self.train_pipe.epoch(epoch))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            wait_ms.append((time.perf_counter() - t0) * 1e3)
            if batch is None:
                break
            i = len(out)
            dev_batch = {k: v for k, v in batch.items() if k != "image_id"}
            t0 = time.perf_counter()
            gen = self.kc.key("train", epoch, i, device=self.device)
            drop_gen = self.kc.key("dropout", epoch, i, device=self.device)
            begin = clock.start()
            metrics = self.train_step(self.state, dev_batch, switches,
                                      seed_weighted=seed_weighted,
                                      generator=gen, student=student,
                                      dropout_generator=drop_gen)
            clock.stop(begin)
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(metrics)
            if (args.checkpoint_save > 0
                    and self.state.step % args.checkpoint_save == 0):
                self._save_checkpoint()
            if args.log_every and (i + 1) % args.log_every == 0:
                self.logger.log({"split": "train", "epoch": epoch,
                                 "it": i + 1,
                                 "loss": float(metrics["loss"])},
                                step=self.state.step)
        return {"metrics": out, "step_ms": clock.millis(),
                # the last wait is the end of the epoch, not a step's
                "data_wait_ms_per_step": float(np.mean(wait_ms[:-1]))
                if out else 0.0,
                "enqueue_ms_per_step": float(np.mean(enqueue_ms))
                if out else 0.0, "capture_ms": 0.0}

    def _run_chunked_epoch(self, epoch: int, feed, switches,
                           seed_weighted: bool) -> dict:
        """K steps a dispatch (engine/scan_train.py, JAX
        Trainer._run_chunked_epoch).  A rolling checkpoint is saved at the
        end of a chunk whose steps cross a multiple of checkpoint_save;
        the log_every records come from the per-step losses at the end."""
        args = self.args
        chunk = int(args.train_dispatch_chunk)
        runner = self._chunk_runner
        if runner is None or runner.chunk != chunk or runner.feed is not feed:
            runner = self._chunk_runner = scan_train.ChunkedEpochRunner(
                feed, self.train_step, chunk, self._needs_seeds)
        host_step = self.state.step

        def on_chunk(offset: int, k: int, metrics) -> None:
            if (args.checkpoint_save > 0
                    and self.state.step // args.checkpoint_save
                    > (self.state.step - k) // args.checkpoint_save):
                self._save_checkpoint()

        rec = runner.run_epoch(self.state, epoch, self.kc, switches,
                               seed_weighted, on_chunk=on_chunk)
        if args.log_every:
            for i, m in enumerate(rec["metrics"]):
                if (i + 1) % args.log_every == 0:
                    self.logger.log({"split": "train", "epoch": epoch,
                                     "it": i + 1, "loss": float(m["loss"])},
                                    step=host_step + i + 1)
        n = max(rec["steps"], 1)
        return {"metrics": rec["metrics"],
                "step_ms": [ms / k for ms, k in zip(rec["chunk_ms"],
                                                    rec["chunk_k"])
                            for _ in range(k)],
                "data_wait_ms_per_step": (rec["plan_ms"]) / n,
                "enqueue_ms_per_step": sum(rec["enqueue_ms"]) / n,
                "capture_ms": sum(rec["capture_ms"])}

    # --------------------------------------------------------------- eval
    def evaluate(self, epoch: int, split: str, snapshot: str = "",
                 on_device: Optional[bool] = None) -> Dict:
        """One pass over `split`; `snapshot` names the weights in the
        record (the test passes at the best snapshots).  on_device: the
        approximate device counters (default args.on_device_eval, as the
        JAX trainer's every pass)."""
        ds, pipe = self.eval_pipes[split]
        res = CamEvaluator(
            self.model, self.args, ds, pipe, split,
            fast=self.args.fast_eval,
            generator=self.kc.key("eval", split, epoch,
                                  device=self.device),
            on_device=on_device).run()
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
