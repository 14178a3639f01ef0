"""Training entry point of the STD_CL, F_CL, TCAM and C_BOX tasks (port
of cli/train.py).

    python -m tcam_wsol_video_tpu_torch.cli.train --task STD_CL \\
        --data_root <root> --metadata_root <folds> ... [--device cpu]
    python -m tcam_wsol_video_tpu_torch.cli.train \\
        --config config_yaml/ytov1_stage2_tcam.yaml \\
        --data_root <root> --metadata_root <folds> \\
        --std_cams_folder <CAM store> --folder_pre_trained_cl <stage 1> \\
        [--sl_tc_epoch_switch_to_sl 1 --im_rec true ...] [--device cpu]
    python -m tcam_wsol_video_tpu_torch.cli.train --task F_CL \\
        --arch UnetFCAM --std_cams_folder <CAM store> --sl_fc true \\
        --crf_fc true --entropy_fc true --max_sizepos_fc true ...
    python -m tcam_wsol_video_tpu_torch.cli.train \\
        --config config_yaml/ytov1_cbox.yaml --data_root <root> \\
        --metadata_root <folds> --std_cams_folder <CAM store> \\
        --folder_pre_trained_cl <stage 1> [--device cpu]

Flags are the JAX CLI's (core/config.py), with --config <yaml> applied
before them.  It builds the data layer (over the CAM store for F_CL,
TCAM and C_BOX; STD_CL reads no store), the model (random weights
from --seed, then the encoder and classifier of --folder_pre_trained_cl
when given: a stage-1 experiment folder written by this package, whose
tcam_pretrained_cl_ch_pt snapshot is read), and runs Trainer.fit:
validation, the epochs, model selection and the test split at the best
snapshots.  TCAM with sl_tc and no --std_cams_folder recomputes its seed
CAMs every step from a frozen stage-1 classifier: the encoder and head of
the folder's tcam_pretrained_seeder_ch_pt snapshot, or random weights
without a folder, as the JAX CLI does.  C_BOX trains DenseBoxNet, whose
encoder (its only stage-1 component) comes from the folder's
tcam_pretrained_cl_ch_pt snapshot, against the same frozen classifier
(the seeder's snapshot, as in JAX, not cb_pretrained_cl_ch_pt); its
seeds come from the CAM store.  The train steps (and the seeder
classifier) compute in --compute_dtype (default bfloat16), validation and
the test passes in --eval_compute_dtype (default float32); parameters,
gradients and checkpoints stay float32.  It runs on the card unless
--device cpu is given; without CUDA it raises.

ILSVRC (ds_chunkable, nbr_chunks, bucket_sz): each epoch trains on the
train split's buckets in turn; --bucket_stage_cmd / --bucket_cleanup_cmd
are shell templates ({bucket} substituted) run by `bash -c` before and
after each bucket.

Several ranks, one process per card (NCCL; gloo under --device cpu):

    python -m torch.distributed.run --nproc_per_node N \
        -m tcam_wsol_video_tpu_torch.cli.train ... [--mesh_dp -1 --mesh_mp 1]

--batch_size is per rank (the global batch is batch_size x mesh_dp);
every split is sharded by the rank's dp index, the card-resident feed is
off (--train_device_cache_mb is taken as 0), and only rank 0 writes
(parallel/mesh.py, engine/trainer.py).
"""
from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from tcam_wsol_video_tpu_torch.core import checkpoint as ckpt
from tcam_wsol_video_tpu_torch.core import constants
from tcam_wsol_video_tpu_torch.core.clock import TRACE
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.core.prng import KeyChain
from tcam_wsol_video_tpu_torch.data import ilsvrc_buckets
from tcam_wsol_video_tpu_torch.data.cam_store import CamStore
from tcam_wsol_video_tpu_torch.data.dataset import WSOLVideoDataset
from tcam_wsol_video_tpu_torch.data.folds import (load_split_metadata,
                                                  subsample_per_class)
from tcam_wsol_video_tpu_torch.data.pipeline import DataPipeline
from tcam_wsol_video_tpu_torch.data.transforms import PairedTransform
from tcam_wsol_video_tpu_torch.engine.trainer import Trainer
from tcam_wsol_video_tpu_torch.models.factory import create_model_from_args
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh


def resolve_metadata_root(args: TCAMConfig) -> TCAMConfig:
    """args with --metadata_root resolved: as given when it is a folder,
    else <data_root>/<metadata_root>/<dataset> when that is one."""
    meta_root = args.metadata_root
    if not os.path.isdir(meta_root):
        cand = os.path.join(args.data_root, meta_root, args.dataset)
        if os.path.isdir(cand):
            meta_root = cand
    return args.replace(metadata_root=meta_root)


def device_from(name: str) -> torch.device:
    """The entry points' --device: the card unless `cpu` is asked for;
    raises when CUDA is asked for and missing."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    return device


def eval_dataset(args: TCAMConfig, kc: KeyChain, split: str, md=None
                 ) -> WSOLVideoDataset:
    """The dataset of `split` (its metadata `md`, else the folds') under
    the eval transform, without a CAM store."""
    if md is None:
        md = load_split_metadata(args.metadata_root, split)
    return WSOLVideoDataset(
        md, os.path.join(args.data_root, args.dataset), split, args.dataset,
        PairedTransform(args.resize_size, args.crop_size, train=False),
        kc, crop_size=args.crop_size)


@TRACE.wrap("setup.data")
def build_data(args: TCAMConfig, kc: KeyChain, device,
               mesh: Optional[pmesh.Mesh] = None):
    """Returns (args with the resolved metadata root, train pipeline,
    {split: (dataset, pipeline)} for val and test).  As in the JAX CLI,
    --h2d_transfer uint8 packs the batches of every split,
    --decode_cache_mb caches the decoded frames of every split, and
    --train_device_cache_mb puts the train split's frames and CAMs on the
    device (the eval splits stream; so does every split with several
    ranks).  Each split is sharded by the mesh's dp index."""
    shards = ({} if mesh is None
              else dict(num_shards=mesh.dp, shard_index=mesh.d))
    feed_mb = (args.train_device_cache_mb
               if mesh is None or mesh.world == 1 else 0)
    args = resolve_metadata_root(args)
    meta_root = args.metadata_root
    data_root = os.path.join(args.data_root, args.dataset)
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
    compact = args.h2d_transfer == "uint8"
    train_pipe = DataPipeline(
        train_ds, args.batch_size, kc, shuffle=True, compact=compact,
        decode_cache_mb=args.decode_cache_mb,
        train_device_cache_mb=feed_mb, device=device, **shards)

    eval_pipes = {}
    for split in (constants.VALIDSET, constants.TESTSET):
        md = load_split_metadata(meta_root, split)
        if split == constants.VALIDSET and args.num_val_sample_per_class:
            md = subsample_per_class(md, args.num_val_sample_per_class,
                                     kc.numpy_rng("val_subsample"))
        ds = eval_dataset(args, kc, split, md)
        eval_pipes[split] = (ds, DataPipeline(
            ds, args.eval_batch_size, kc, shuffle=False, compact=compact,
            decode_cache_mb=args.decode_cache_mb, device=device, **shards))
    return args, train_pipe, eval_pipes


def _load_stage1_snapshot(folder: str, snapshot: str, model) -> int:
    """Loads the encoder and classification head of the best-model
    snapshot in folder/snapshot (folder itself when that is no folder)
    into model (those of the two it has); returns the snapshot's step."""
    chpt_dir = os.path.join(folder, snapshot)
    if not os.path.isdir(chpt_dir):
        chpt_dir = folder
    step, payload = ckpt.load_best_model(chpt_dir)
    if payload is None:
        raise FileNotFoundError(f"no best-model snapshot under {chpt_dir}")
    # the components the model has: DenseBoxNet takes the encoder alone
    ckpt.load_components(model, payload["components"],
                         only=[c for c in ("encoder", "classification_head")
                               if isinstance(getattr(model, c, None),
                                             torch.nn.Module)])
    return step


def load_pretrained_classifier_weights(args: TCAMConfig, model) -> None:
    """The encoder and classification head of the stage-1 snapshot in
    --folder_pre_trained_cl (its tcam_pretrained_cl_ch_pt subfolder when
    present); DenseBoxNet's encoder alone."""
    if args.folder_pre_trained_cl:
        _load_stage1_snapshot(args.folder_pre_trained_cl,
                              args.tcam_pretrained_cl_ch_pt, model)


def load_seeder_classifier(args: TCAMConfig, kc: KeyChain, device
                           ) -> Tuple[torch.nn.Module, Optional[int]]:
    """The frozen stage-1 classifier whose CAMs seed TCAM without a CAM
    store, and which scores C_BOX's boxes (JAX cli/train.py and
    cli/evaluate.py): the STD_CL model of args, random weights
    from the key chain's "cls" seed (the stage-2 model's draw from --seed
    is left as it is), then the encoder and classification head of the
    tcam_pretrained_seeder_ch_pt snapshot of --folder_pre_trained_cl
    when given; in eval mode, without gradients.  Returns (model, the
    snapshot's step, None without a folder)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(kc.key("cls", device="cpu").initial_seed())
        model = create_model_from_args(args, override_arch_for_classifier=True,
                                       device=device)
    step = None
    if args.folder_pre_trained_cl:
        step = _load_stage1_snapshot(args.folder_pre_trained_cl,
                                     args.tcam_pretrained_seeder_ch_pt, model)
    return model.eval().requires_grad_(False), step


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns {'test': {snapshot: results}, 'records': per-epoch train
    and per-pass eval records, 'outd': the experiment folder,
    'seeder_step': the step of the frozen classifier's snapshot (None
    when there is none, or its weights are random), 'args': the finalized
    config}."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args, ns = parse_args(argv, extra)
    device = pmesh.maybe_init_distributed(device_from(ns.device))
    mesh = pmesh.make_mesh(args.mesh_dp, args.mesh_mp)
    kc = KeyChain(args.seed)
    args, train_pipe, eval_pipes = build_data(args, kc, device, mesh)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = create_model_from_args(args, device=device)
    load_pretrained_classifier_weights(args, model)
    classifier, seeder_step = None, None
    if args.task == constants.C_BOX or (
            args.task == constants.TCAM and args.sl_tc
            and train_pipe.ds.cam_store is None):
        classifier, seeder_step = load_seeder_classifier(args, kc, device)
    if (args.task == constants.F_CL and (args.sl_fc or args.sl_tc)
            and train_pipe.ds.cam_store is None):
        # the JAX step recomputes the seed CAMs for TCAM only
        warnings.warn("F_CL without --std_cams_folder seeds from the "
                      "dataset's all-zero CAMs (no seeds are drawn), as in "
                      "the JAX package")

    trainer = Trainer(args, model, train_pipe, eval_pipes, keychain=kc,
                      device=device, classifier=classifier, mesh=mesh)
    if args.ds_chunkable and (args.bucket_stage_cmd
                              or args.bucket_cleanup_cmd):
        trainer.bucket_stager = ilsvrc_buckets.shell_stager(
            args.bucket_stage_cmd, args.bucket_cleanup_cmd)
        trainer.logger.log(f"bucket stager: stage={args.bucket_stage_cmd!r}"
                           f" cleanup={args.bucket_cleanup_cmd!r}")
    results = trainer.fit()
    trainer.logger.log({"final": {
        tag: {k: v for k, v in r.items() if isinstance(v, (int, float))}
        for tag, r in results.items()}})
    if trainer.is_master:
        with open(os.path.join(trainer.outd, "passed.txt"), "w") as f:
            f.write("done\n")
    return {"test": results, "records": trainer.records,
            "outd": trainer.outd, "seeder_step": seeder_step, "args": args}


if __name__ == "__main__":
    main()
    pmesh.shutdown()
