"""Standalone evaluation of a trained snapshot (port of cli/evaluate.py).

    python -m tcam_wsol_video_tpu_torch.cli.evaluate --task TCAM \\
        --arch UnetTCAM --data_root <root> --metadata_root <folds> \\
        --exp_dir <experiment folder> [--split test] \\
        [--eval_checkpoint_type best_localization] [--device cpu]

(--task F_CL --arch UnetFCAM for an F_CL run; --im_rec true when the
run trained the reconstruction head, whose weights the snapshot holds;
--task C_BOX --arch DenseBoxNet --folder_pre_trained_cl <stage 1> for a
C_BOX run, whose frozen classifier is the stage-1 folder's
tcam_pretrained_seeder_ch_pt snapshot, as in training: its boxes are
scored instead of CAMs.)
It loads the eval_checkpoint_type snapshot of --exp_dir into the model of
--task, runs the split through the evaluator (the CAM of each image, the
host box sweep, MaxBoxAcc at each IoU threshold, top-1 classification)
at --eval_compute_dtype (default float32) and prints the numeric results
as one JSON object.  The eval knobs apply (--eval_sweep, --eval_transfer,
--eval_pipeline_depth, --eval_device_cache); --on_device_eval true gives
the approximate device counters instead, as JAX's CLI does.  It runs on the card
unless --device cpu is given; without CUDA it raises.

Under `python -m torch.distributed.run --nproc_per_node N` each rank
scores its shard of the split (by its dp index, --mesh_dp / --mesh_mp as
in training) and the counters are summed over the ranks; rank 0 logs and
prints the results.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from tcam_wsol_video_tpu_torch.cli.train import (device_from, eval_dataset,
                                                 load_seeder_classifier,
                                                 resolve_metadata_root)
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.engine.evaluator import CamEvaluator
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the evaluator's results (without the curves)."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--exp_dir", required=True,
                       help="experiment folder holding the snapshots")
    extra.add_argument("--split", default=constants.TESTSET)
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = pmesh.maybe_init_distributed(device_from(ns.device))
    mesh = pmesh.make_mesh(args.mesh_dp, args.mesh_mp)
    args = resolve_metadata_root(args)
    # the snapshot first: a wrong --exp_dir fails before any data work
    chpt_dir = os.path.join(ns.exp_dir, args.eval_checkpoint_type)
    step, payload = ckpt.load_best_model(chpt_dir)
    if payload is None:
        raise FileNotFoundError(f"no best-model snapshot under {chpt_dir}")

    kc = KeyChain(args.seed)
    ds = eval_dataset(args, kc, ns.split)
    # as the JAX CLI: float32 batches whatever --h2d_transfer says, and no
    # decoded-frame cache (one pass decodes each frame once); so under
    # --h2d_transfer uint8 this sees the float pixels that the trainer's
    # test pass sees rounded
    pipe = DataPipeline(ds, args.eval_batch_size, kc, shuffle=False,
                        device=device, num_shards=mesh.dp,
                        shard_index=mesh.d)
    model = pmesh.state_sharding(create_model_from_args(args, device=device),
                                 mesh)
    ckpt.load_components(model, payload["components"])

    logger = ExpLogger(ns.exp_dir, is_master=pmesh.is_master())
    logger.log(f"evaluating {args.eval_checkpoint_type} (step {step}) on "
               f"{ns.split}")
    classifier = (load_seeder_classifier(args, kc, device)[0]
                  if args.task == constants.C_BOX else None)
    res = CamEvaluator(model, args, ds, pipe, ns.split, fast=False,
                       generator=kc.key("eval", ns.split, device=device),
                       classifier=classifier, mesh=mesh).run()
    res.pop("curves", None)
    printable = {k: v for k, v in res.items()
                 if isinstance(v, (int, float, list))}
    logger.log(printable)
    if pmesh.is_master():
        print(json.dumps(printable))
    return res


if __name__ == "__main__":
    main()
    pmesh.shutdown()
