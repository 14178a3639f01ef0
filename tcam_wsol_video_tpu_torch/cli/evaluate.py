"""Standalone evaluation of a trained snapshot (port of cli/evaluate.py,
one process).

    python -m tcam_wsol_video_tpu_torch.cli.evaluate --task TCAM \\
        --arch UnetTCAM --data_root <root> --metadata_root <folds> \\
        --exp_dir <experiment folder> [--split test] \\
        [--eval_checkpoint_type best_localization] [--device cpu]

(--task F_CL --arch UnetFCAM for an F_CL run; --im_rec true when the
run trained the reconstruction head, whose weights the snapshot holds.)
It loads the eval_checkpoint_type snapshot of --exp_dir into the model of
--task, runs the split through the evaluator (the CAM of each image, the
host box sweep, MaxBoxAcc at each IoU threshold, top-1 classification)
at --eval_compute_dtype (default float32) and prints the numeric results
as one JSON object.  The eval knobs apply (--eval_sweep, --eval_transfer,
--eval_pipeline_depth, --eval_device_cache); --on_device_eval true gives
the approximate device counters instead, as JAX's CLI does.  It runs on the card
unless --device cpu is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from tcam_wsol_video_tpu_torch.cli.train import (device_from, eval_dataset,
                                                 resolve_metadata_root)
from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import parse_args
from tcam_wsol_video_tpu_torch.core.logger import ExpLogger
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.engine.evaluator import CamEvaluator
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the evaluator's results (without the curves)."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--exp_dir", required=True,
                       help="experiment folder holding the snapshots")
    extra.add_argument("--split", default=constants.TESTSET)
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = device_from(ns.device)
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
                        device=device)
    model = create_model_from_args(args, device=device)
    ckpt.load_components(model, payload["components"])

    logger = ExpLogger(ns.exp_dir)
    logger.log(f"evaluating {args.eval_checkpoint_type} (step {step}) on "
               f"{ns.split}")
    res = CamEvaluator(model, args, ds, pipe, ns.split, fast=False,
                       generator=kc.key("eval", ns.split,
                                        device=device)).run()
    res.pop("curves", None)
    printable = {k: v for k, v in res.items()
                 if isinstance(v, (int, float, list))}
    logger.log(printable)
    print(json.dumps(printable))
    return res


if __name__ == "__main__":
    main()
