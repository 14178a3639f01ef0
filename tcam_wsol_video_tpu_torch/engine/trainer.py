"""Training engine of the STD_CL, F_CL, TCAM and C_BOX tasks: epoch loop,
evaluation, model selection and checkpoints (port of engine/trainer.py).

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

C_BOX (engine/cbox_steps.py) trains DenseBoxNet against the frozen
stage-1 classifier given as `classifier`, one step a dispatch (JAX keeps
it off the chunked route); under cb_pp_box_min_size_type size_data the
minimum box sizes come from the val split's GT boxes
(data/folds.build_size_priors).  Its epoch records add the share of
valid boxes, and its evaluations score the predicted boxes.

ILSVRC (ds_chunkable): an epoch trains on the nbr_buckets buckets of the
train split in turn (data/ilsvrc_buckets.py: each bucket the ids of its
chunk files), between the stage and cleanup commands of an attached
bucket_stager; the step keys run on across the buckets, as in JAX.

The visuals (rank 0; JAX's hooks): with plot_tr_cam_progress, after each
epoch the CAMs of plot_tr_cam_progress_n fixed train frames (the first
train ids' frames of the first plotted epoch, at the eval geometry) go to
progress/epoch_<e>.png; the test passes of `fit` dump the prediction
sheets under visuals/test/ and write best_tau_test_<snapshot>.yaml and
boxacc_test_<snapshot>.png; dump_performances writes performances.json,
.pkl, .txt and the meters' curves (performances.png).  A failure in
these host files is logged, never raised: training goes on, as in JAX.

Several ranks (torch.distributed, one process per device; JAX's
multi-process branch): the trainer makes the (mesh_dp, mesh_mp) mesh
(parallel/mesh.py) and hands it to the steps and the evaluator, shards
the classification head's fc over mp, and broadcasts every parameter and
buffer from rank 0 after the init and after a checkpoint load.  Each
rank's pipeline yields its shard; the steps compute the rank's part of
the global step and return the global batch's metrics, so the epoch
totals are the global ones.  The card-resident feed is off (and with it
the chunked route), as in JAX.  The evaluator sums its counters over the
dp group, so model selection and the student snapshot are the same on
every rank.  Only rank 0 writes files; snapshots and checkpoints hold the
full head.
"""
from __future__ import annotations

import copy
import json
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tcam_wsol_video_tpu_torch.cams.seeding import (cbox_seeder_cfg_from_args,
                                                    seeder_cfg_from_args)
from tcam_wsol_video_tpu_torch.cams.temporal import DecayTemp
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import SpanClock
from tcam_wsol_video_tpu_torch.core.config import PORTED_TASKS, experiment_tag
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import ilsvrc_buckets
from tcam_wsol_video_tpu_torch.data.folds import (build_size_priors,
                                                  dump_flat_mapping)
from tcam_wsol_video_tpu_torch.engine.cbox_steps import make_cbox_train_step
from tcam_wsol_video_tpu_torch.engine.evaluator import CamEvaluator
from tcam_wsol_video_tpu_torch.engine.lr import build_lr_fn
from tcam_wsol_video_tpu_torch.engine.optim import build_optimizer, set_lr
from tcam_wsol_video_tpu_torch.engine import scan_train
from tcam_wsol_video_tpu_torch.engine.state import TrainState
from tcam_wsol_video_tpu_torch.engine.steps import (dequantize_cams_np,
                                                    make_cam_eval_step,
                                                    make_train_step)
from tcam_wsol_video_tpu_torch.losses.build import get_loss
from tcam_wsol_video_tpu_torch.losses.elb import update_t
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh
from tcam_wsol_video_tpu_torch.viz import wsol_viz


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
                 classifier=None, mesh: Optional[pmesh.Mesh] = None):
        """eval_pipes: {split: (dataset, pipeline)}; mesh: the process mesh
        (default make_mesh(args.mesh_dp, args.mesh_mp)); classifier: the
        frozen stage-1 classifier, whose CAMs seed a TCAM run without a CAM
        store (the train step recomputes them, as the JAX trainer's
        _recompute_cams does), and which scores C_BOX's boxes (required
        there)."""
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
        # the mesh (JAX's :89-154 with one device a process): the head's
        # fc takes its class slice before the optimizer sees it
        self.mesh = mesh or pmesh.make_mesh(args.mesh_dp, args.mesh_mp)
        self.is_master = pmesh.is_master()
        if self.mesh.world > 1:
            pmesh.state_sharding(model, self.mesh)
            pmesh.broadcast_state(model, self.mesh)
            if classifier is not None:
                pmesh.broadcast_state(classifier, self.mesh)
        optimizer = build_optimizer(args, model, self.lr_fn(0))
        self.state = TrainState(model, optimizer, elb_t=args.elb_init_t)
        tcam = args.task == constants.TCAM
        self.cbox = args.task == constants.C_BOX
        self.classifier = classifier
        self._recompute_cams = (
            tcam and bool(args.sl_tc)
            and getattr(train_pipe.ds, "cam_store", None) is None
            and classifier is not None)
        if self.cbox:
            if classifier is None:
                raise ValueError("C_BOX needs the frozen classifier")
            self.train_step = make_cbox_train_step(
                self.master_loss, args, cbox_seeder_cfg_from_args(args),
                classifier, self._size_priors_min_s(), mesh=self.mesh)
        else:
            # F_CL seeds with the TCAM seeder and its sl_tc_* keys, as in
            # JAX
            self.train_step = make_train_step(
                self.master_loss, args,
                None if args.task == constants.STD_CL
                else seeder_cfg_from_args(args),
                classifier_model=(classifier if self._recompute_cams
                                  else None), mesh=self.mesh)
        self._needs_seeds = (args.task in (constants.F_CL, constants.TCAM)
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
        # ILSVRC: a BucketStager run around each bucket (the train CLI
        # attaches one), and the train ids' dataset indices
        self.bucket_stager: Optional[ilsvrc_buckets.BucketStager] = None
        self._id_to_index: Optional[Dict[str, int]] = None
        self._progress: Optional[tuple] = None
        self.outd = os.path.join(args.outd, experiment_tag(args),
                                 args.exp_id)
        if self.is_master:
            os.makedirs(self.outd, exist_ok=True)
        self.logger = ExpLogger(self.outd, is_master=self.is_master)
        if self.mesh.backend:
            self.logger.log(
                f"mesh: dp={self.mesh.dp} mp={self.mesh.mp} over "
                f"{self.mesh.backend}" + (
                    "; the card-resident feed and the chunked dispatch are "
                    "off across processes" if self.mesh.world > 1 else ""))

    # ------------------------------------------------------------ buckets
    def _train_buckets(self):
        """This epoch's buckets, staged when a stager is attached; [None]
        when the train split is not chunked."""
        if not self.args.ds_chunkable:
            yield None
            return
        buckets = range(self.args.nbr_buckets)
        yield from (self.bucket_stager(buckets)
                    if self.bucket_stager is not None else buckets)

    def _bucket_subset(self, bucket) -> Optional[np.ndarray]:
        """The train dataset's indices of one bucket's ids."""
        if bucket is None:
            return None
        ids = ilsvrc_buckets.bucket_image_ids(
            self.args.metadata_root, bucket, self.args.nbr_chunks,
            self.args.bucket_sz)
        if self._id_to_index is None:
            train_ids = self.train_pipe.ds.md.image_ids
            self._id_to_index = {iid: i for i, iid in enumerate(train_ids)}
        subset = np.asarray([self._id_to_index[i] for i in ids
                             if i in self._id_to_index], np.int64)
        if not subset.size:
            raise ValueError(f"bucket {bucket} matched no training ids")
        return subset

    def _epoch_batches(self, epoch: int):
        """The epoch's train batches, bucket after bucket."""
        for bucket in self._train_buckets():
            yield from self.train_pipe.epoch(
                epoch, subset=self._bucket_subset(bucket))

    # -------------------------------------------------------------- train
    def _size_priors_min_s(self) -> Optional[np.ndarray]:
        """C_BOX's per-class minimum area share from the val split's GT
        boxes under cb_pp_box_min_size_type size_data, else None."""
        if self.args.cb_pp_box_min_size_type != constants.SIZE_DATA:
            return None
        val = self.eval_pipes.get(constants.VALIDSET)
        if val is None:
            raise ValueError("cb_pp_box_min_size_type size_data needs a val "
                             "split")
        return build_size_priors(val[0].md, self.args.crop_size,
                                 self.args.num_classes)["min_s"]

    def _save_checkpoint(self) -> None:
        # every rank gathers the full head (a collective); rank 0 writes
        model_sd = self.model.state_dict()
        opt_sd = pmesh.full_optimizer_state(self.state.optimizer,
                                            self.model)
        if not self.is_master:
            return
        ckpt.save_checkpoint(self.outd, self.state, model_sd, opt_sd)
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
        self.mesh.clock = SpanClock(self.device)
        if chunked:
            run = self._run_chunked_epoch(epoch, feed, switches,
                                          seed_weighted)
        else:
            run = self._run_per_step_epoch(epoch, switches, seed_weighted,
                                           student)
        wall_ms = (time.perf_counter() - t_epoch) * 1e3
        comm_ms = self.mesh.clock.millis()
        self.mesh.clock = None
        zero = torch.zeros((), device=self.device)
        tot_loss, n_corr, n = zero.clone(), zero.clone(), zero.clone()
        valid_boxes = zero.clone()
        terms: Dict[str, torch.Tensor] = {}
        for metrics in run["metrics"]:
            tot_loss += metrics["loss"]
            n_corr += metrics["n_correct"]
            n += metrics["n"]
            valid_boxes += metrics.get("valid_boxes", 0.0)
            for k, v in metrics.items():
                if k not in ("loss", "n_correct", "n", "valid_boxes"):
                    terms[k] = terms.get(k, zero) + v
        i = len(run["metrics"])
        step_ms = run["step_ms"]

        # epoch end: ELB anneal, then a checkpoint holding the annealed t
        self.state.elb_t = update_t(self.state.elb_t, args.elb_mulcoef,
                                    args.elb_max_t)
        if args.checkpoint_save > 0:
            self._save_checkpoint()
        if self.is_master and args.plot_tr_cam_progress:
            self._plot_progress(epoch)
        out = {
            "epoch": epoch,
            "loss": float(tot_loss) / max(1, i),
            "step_losses": [float(m["loss"]) for m in run["metrics"]],
            # each loss term's mean over the epoch's steps
            "terms": {k: float(v) / max(1, i) for k, v in terms.items()},
            "classification": 100.0 * float(n_corr) / max(1.0, float(n)),
            "n": int(n), "steps": i, "wall_ms": wall_ms,
            "median_step_ms": float(np.median(step_ms)) if step_ms else 0.0,
            "step_ms": step_ms,
            # the gradient all-reduce over the dp group (0 on one rank)
            "allreduce_ms_per_step": float(np.mean(comm_ms))
            if comm_ms else 0.0,
            "mesh": self.mesh.shape,
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
        if self.cbox:
            # the share of the epoch's frames whose trained box was valid
            out["valid_box_share"] = float(valid_boxes) / max(1.0, float(n))
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
        batches = self._epoch_batches(epoch)
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

        rec = None
        for bucket in self._train_buckets():
            part = runner.run_epoch(
                self.state, epoch, self.kc, switches, seed_weighted,
                on_chunk=on_chunk, subset=self._bucket_subset(bucket),
                key_offset=0 if rec is None else rec["steps"])
            if rec is None:
                rec = part
                continue
            rec["steps"] += part["steps"]
            rec["plan_ms"] += part["plan_ms"]
            for k in ("metrics", "chunk_ms", "chunk_k", "enqueue_ms",
                      "capture_ms"):
                rec[k] += part[k]
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
                 on_device: Optional[bool] = None,
                 visual_dump: bool = False) -> Dict:
        """One pass over `split`; `snapshot` names the weights in the
        record (the test passes at the best snapshots).  on_device: the
        approximate device counters (default args.on_device_eval, as the
        JAX trainer's every pass).  visual_dump: the prediction sheets
        under visuals/<split> (rank 0)."""
        ds, pipe = self.eval_pipes[split]
        vis_dir = (os.path.join(self.outd, "visuals", split)
                   if visual_dump and self.is_master else "")
        res = CamEvaluator(
            self.model, self.args, ds, pipe, split,
            fast=self.args.fast_eval,
            generator=self.kc.key("eval", split, epoch,
                                  device=self.device),
            on_device=on_device,
            classifier=self.classifier if self.cbox else None,
            mesh=self.mesh, visual_dump_dir=vis_dir).run()
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
        if self.is_master:
            ckpt.save_best_model(
                os.path.join(self.outd, tag), self.state.step, self.model,
                extra={"epoch": epoch, "elb_t": self.state.elb_t,
                       metric: value}, state_dict=snap)
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
        if not self.is_master:
            return
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
        ckpt.restore_checkpoint(
            self.state, payload,
            lambda sd: pmesh.load_optimizer_state(self.state.optimizer,
                                                  self.model, sd))
        pmesh.broadcast_state(self.model, self.mesh)
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
                                         constants.TESTSET, snapshot=tag,
                                         visual_dump=True)
            self.dump_eval_artifacts(f"{constants.TESTSET}_{tag}",
                                     results[tag])
        self.model.load_state_dict(current)
        self.dump_performances(results)
        return results

    def dump_performances(self, results: Dict) -> None:
        """Meters, per-epoch records and the final test results (rank 0)."""
        if not self.is_master:
            return
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
        hist = {k: m.history for k, m in self.meters.items()}
        best = {k: {"value": m.best_value, "epoch": m.best_epoch}
                for k, m in self.meters.items()}
        with open(os.path.join(self.outd, "performances.pkl"), "wb") as f:
            pickle.dump({"history": hist, "best": best}, f)
        with open(os.path.join(self.outd, "performances.txt"), "w") as f:
            for k, m in self.meters.items():
                f.write(f"{k}: best={m.best_value} @ep{m.best_epoch} "
                        f"history={m.history}\n")
        self._host_file("performances.png", lambda path: (
            wsol_viz.plot_meter_curves(hist, path)))

    def _host_file(self, name: str, write) -> None:
        """write(path) for a visual under outd; a failure is logged and
        training goes on (JAX's rule for its plots)."""
        path = os.path.join(self.outd, name)
        try:
            write(path)
        except Exception as e:  # noqa: BLE001 - a plot never kills a run
            self.logger.log(f"could not write {path}: {e!r}")

    def dump_eval_artifacts(self, split: str, res: Dict) -> None:
        """best_tau_<split>.yaml and the BoxAcc-against-tau curves
        boxacc_<split>.png (rank 0)."""
        if not self.is_master:
            return
        if "best_tau" in res:
            with open(os.path.join(self.outd, f"best_tau_{split}.yaml"),
                      "w") as f:
                f.write(dump_flat_mapping(
                    {"iou_thresholds": list(self.args.iou_threshold_list),
                     "best_tau": list(res["best_tau"])}))
        curves = res.get("curves")
        if curves:
            self._host_file(f"boxacc_{split}.png", lambda path: (
                wsol_viz.plot_boxacc_curves(curves["x"], curves, path)))

    def _plot_progress(self, epoch: int) -> None:
        """progress/epoch_<e>.png: the CAMs of the fixed train frames
        under the current weights."""
        def write(path):
            if self._progress is None:
                ds = self.train_pipe.ds
                n = min(self.args.plot_tr_cam_progress_n, len(ds))
                fids = [ds.sample_ids(i)[0] for i in range(n)]
                labels = [ds.md.labels[ds.md.image_ids[i]]
                          for i in range(n)]
                c = ds.crop_size
                norm, raw = self.train_pipe._load_pixels(
                    [f"{ds.data_root}/{f}" for f in fids], c, c, [0] * n,
                    [0] * n, [0] * n)
                self._progress = (
                    norm, raw.float().cpu().numpy(),
                    torch.as_tensor(labels, dtype=torch.int64,
                                    device=norm.device),
                    make_cam_eval_step(self.model, self.args))
            norm, raw, labels, step = self._progress
            cams, _ = step(norm, targets=labels,
                           generator=self.kc.key("progress", epoch,
                                                 device=self.device))
            wsol_viz.plot_progress_grid(
                list(raw), list(dequantize_cams_np(cams.cpu().numpy())),
                path, epoch)

        self._host_file(os.path.join("progress", f"epoch_{epoch:04d}.png"),
                        write)
