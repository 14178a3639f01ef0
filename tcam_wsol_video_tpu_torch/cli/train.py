"""Training entry point of the TCAM task (port of cli/train.py).

    python -m tcam_wsol_video_tpu_torch.cli.train --task TCAM \\
        --arch UnetTCAM --data_root <root> --metadata_root <folds> \\
        --std_cams_folder <CAM store> --sl_tc true --crf_tc true ... \\
        [--device cpu]

Flags are the JAX CLI's (core/config.py).  It builds the data layer over
the CAM store, the model (random weights from --seed, then the encoder
and classifier of --folder_pre_trained_cl when given: a snapshot folder
written by this package), and runs Trainer.fit: validation, the epochs,
model selection and the test split at the best snapshots.  It runs on the
card unless --device cpu is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.folds import (load_split_metadata,
                                                  subsample_per_class)
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args


def build_data(args: TCAMConfig, kc: KeyChain, device):
    """Returns (args with the resolved metadata root, train pipeline,
    {split: (dataset, pipeline)} for val and test)."""
    meta_root = args.metadata_root
    data_root = os.path.join(args.data_root, args.dataset)
    if not os.path.isdir(meta_root):
        cand = os.path.join(args.data_root, meta_root, args.dataset)
        if os.path.isdir(cand):
            meta_root = cand
    args = args.replace(metadata_root=meta_root)
    cam_store = (CamStore(args.std_cams_folder) if args.std_cams_folder
                 else None)

    train_md = load_split_metadata(meta_root, constants.TRAINSET,
                                   proxy=args.proxy_training_set)
    train_ds = WSOLVideoDataset(
        train_md, data_root, constants.TRAINSET, args.dataset,
        PairedTransform(args.resize_size, args.crop_size, train=True),
        kc, crop_size=args.crop_size, cam_store=cam_store,
        knn_tc=args.knn_tc, sl_tc_knn=args.sl_tc_knn,
        sl_tc_knn_mode=args.sl_tc_knn_mode, use_roi=args.sl_tc_use_roi,
        roi_method=args.sl_tc_roi_method,
        p_min_area_roi=args.sl_tc_roi_min_size)
    train_pipe = DataPipeline(train_ds, args.batch_size, kc, shuffle=True,
                              device=device)

    eval_pipes = {}
    for split in (constants.VALIDSET, constants.TESTSET):
        md = load_split_metadata(meta_root, split)
        if split == constants.VALIDSET and args.num_val_sample_per_class:
            md = subsample_per_class(md, args.num_val_sample_per_class,
                                     kc.numpy_rng("val_subsample"))
        ds = WSOLVideoDataset(
            md, data_root, split, args.dataset,
            PairedTransform(args.resize_size, args.crop_size, train=False),
            kc, crop_size=args.crop_size)
        eval_pipes[split] = (ds, DataPipeline(ds, args.eval_batch_size, kc,
                                              shuffle=False, device=device))
    return args, train_pipe, eval_pipes


def load_pretrained_classifier_weights(args: TCAMConfig, model) -> None:
    """The encoder and classification head of the stage-1 snapshot in
    --folder_pre_trained_cl (its tcam_pretrained_cl_ch_pt subfolder when
    present)."""
    folder = args.folder_pre_trained_cl
    if not folder:
        return
    chpt_dir = os.path.join(folder, args.tcam_pretrained_cl_ch_pt)
    if not os.path.isdir(chpt_dir):
        chpt_dir = folder
    _, payload = ckpt.load_best_model(chpt_dir)
    if payload is None:
        raise FileNotFoundError(f"no best-model snapshot under {chpt_dir}")
    ckpt.load_components(model, payload["components"],
                         only=["encoder", "classification_head"])


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns {'test': {snapshot: results}, 'records': per-epoch train
    and per-pass eval records, 'outd': the experiment folder}."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = build_data(args, kc, device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = create_model_from_args(args, device=device)
    load_pretrained_classifier_weights(args, model)

    trainer = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                      device=device)
    results = trainer.fit()
    trainer.logger.log({"final": {
        tag: {k: v for k, v in r.items() if isinstance(v, (int, float))}
        for tag, r in results.items()}})
    with open(os.path.join(trainer.outd, "passed.txt"), "w") as f:
        f.write("done\n")
    return {"test": results, "records": trainer.records,
            "outd": trainer.outd}


if __name__ == "__main__":
    main()
