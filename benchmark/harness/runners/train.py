"""The training runner: the objects cli/train.main builds, one warm-up
epoch, then whole epochs of Trainer.train_epoch for the window.

Set-up, from process start: the set drawn and written (harness/synth.py),
the program's config (parse_args over the configuration's and the
traffic's flags), its data layer (build_data), its model
(create_model_from_args) holding the benchmark's weights
(harness/weights.py), the Trainer, and epoch 0 through train_epoch with
StepTap copying its first three steps (every kernel is built and, on the
chunked route, every graph shape captured there).  The window then trains
epochs 1, 2, ... until --seconds have passed, and ends at an epoch's end
(train_epoch waits for the device there): its frames over its seconds are
the rate.  With --trace 1 one more epoch runs under the profiler after the
window.  Then the program's state is freed and the reference checks the
three steps (harness/check.py)."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check, flops, synth, trace as tr, weights
from benchmark.harness.tap import StepTap


def program_argv(cfg: dict, traffic: dict, seed: int, data: dict,
                 outd: str, device: torch.device) -> list:
    flags = {**cfg["flags"], **traffic["flags"], "seed": seed,
             "data_root": data["root"], "metadata_root":
             data["metadata_root"], "outd": outd, "exp_id": "bench",
             "checkpoint_save": 0, "log_every": 0}
    if cfg["task"] != "STD_CL":
        flags["std_cams_folder"] = data["cam_store"]
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv + ["--device", device.type]


def _plant(trainer, fault: Optional[str]) -> None:
    """A fault under the timed path (the tests' check of `correct`):
    the optimizer's step skipped; half of each batch cut before the step;
    or the loss terms taken over the first half of the batch's rows."""
    if fault is None:
        return
    if fault == "state_unchanged":
        trainer.state.optimizer.step = lambda *a, **k: None
        return
    if fault == "half_loss":
        inner_loss = trainer.master_loss.compute

        def first_half(inputs, *a, **k):
            n = inputs.cl_logits.shape[0] // 2
            return inner_loss(dataclasses.replace(inputs, **{
                f.name: getattr(inputs, f.name)[:n]
                for f in dataclasses.fields(inputs)
                if isinstance(getattr(inputs, f.name), torch.Tensor)
                and getattr(inputs, f.name).shape[:1] == (2 * n,)}),
                *a, **k)
        trainer.master_loss.compute = first_half
        return
    if fault == "half_batch":
        inner = trainer.train_step

        def step(state, batch, *a, **k):
            n = batch["label"].shape[0] // 2
            if k.get("gumbel") is not None:
                k["gumbel"] = k["gumbel"][:n]
            return inner(state, {key: v[:n] if isinstance(v, torch.Tensor)
                                 else v for key, v in batch.items()},
                         *a, **k)
        trainer.train_step = step
        return
    raise ValueError(f"unknown fault {fault!r}")


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, work: str,
        calibrate: bool = False, fault: Optional[str] = None,
        alternates=check.ALTERNATES, flags: Optional[dict] = None) -> dict:
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core.config import parse_args
    from tcam_wsol_video_tpu_torch.core.prng import KeyChain
    from tcam_wsol_video_tpu_torch.data.synthetic import encode_jpeg
    from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
    from tcam_wsol_video_tpu_torch.models.factory import \
        create_model_from_args
    from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh

    cfg, traffic = cell["config"], cell["traffic"]
    if flags:
        cfg = {**cfg, "flags": {**cfg["flags"], **flags}}
    classes = int(cfg["flags"]["num_classes"])
    data = synth.make_set(os.path.join(work, "set"), cfg["set"], seed,
                          device, lambda img: encode_jpeg(img, device))
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--device", default="cuda")
    args, _ = parse_args(program_argv(cfg, traffic, seed, data,
                                      os.path.join(work, "exps"), device),
                         extra)
    mesh = pmesh.make_mesh(args.mesh_dp, args.mesh_mp)
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = cli_train.build_data(args, kc, device,
                                                        mesh)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = create_model_from_args(args, device=device)
    model.load_state_dict(weights.make(cfg["task"], classes, seed, device))
    trainer = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                      device=device, classifier=None, mesh=mesh)
    _plant(trainer, fault)
    tap = StepTap(trainer, needs_seeds=cfg["task"] != "STD_CL")
    warm = trainer.train_epoch(0)
    snap = tap.release()
    setup_s = time.perf_counter() - t_start

    records = []
    t0 = time.perf_counter()
    while True:
        records.append(trainer.train_epoch(len(records) + 1))
        if time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = sum(r["steps"] for r in records)
    ctx = {
        "cell": cell["entry"]["name"], "config": cfg, "traffic": traffic,
        "setup_s": setup_s, "window_s": window_s, "records": records,
        "steps": steps, "frames": sum(r["n"] for r in records),
        "failed": int(sum(not np.isfinite(v) for r in records
                          for v in r["step_losses"])),
        "warm_route": warm.get("data_route"),
    }
    if trace:
        batch = int(cfg["flags"]["batch_size"])
        crop = int(cfg["flags"]["crop_size"])
        rec, ctx["trace"] = tr.traced(
            lambda: trainer.train_epoch(len(records) + 1),
            os.path.join(work, "trace.json"))
        ctx["trace"]["steps"] = rec["steps"]
        ctx["model_flops_per_step"] = flops.cached_model_flops(
            os.path.join(work, "..", "cache"), cfg["name"], cfg["task"],
            classes, batch, crop)
        ctx["crf"] = (flops.filter_bound(batch, crop * crop)
                      if cfg["flags"].get("crf_tc") in (True, "true", "True")
                      and cfg["flags"].get("crf_impl", "exact") == "exact"
                      else None)
    if device.type == "cuda":
        ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)

    del trainer, model, train_pipe, eval_pipes
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ctx["numbers"] = check.numbers(
        snap, data, cfg, seed, weights.make(cfg["task"], classes, seed,
                                            device),
        device, calibrate=calibrate, alternates=alternates)
    ctx["check_s"] = time.perf_counter() - t_check
    ctx["tapped_calls"] = snap["calls"]
    return ctx
