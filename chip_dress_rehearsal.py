"""The dress rehearsal of the two-stage chain on one NVIDIA GPU: the
chain of cmds/e2e_dress_rehearsal_tpu.sh through the port's three CLIs,
one seed per invocation.

    python3 chip_dress_rehearsal.py --seed 0 [--compute_dtype bfloat16]
    python3 chip_dress_rehearsal.py --summarize chiprun_out/dress_*.json

A run writes the script's synthetic set with nvJPEG under build/dress/
(data/synthetic.make_synthetic_dataset: 10 classes, 8 videos x 5 shots x
8 frames of 256 x 320, i.e. 400 train shots and 3200 train frames), then
  1. stage 1: cli/train.py --task STD_CL, 10 epochs at lr 0.01, bs 32,
     eval bs 64, cam_curve_interval 0.004, 20 val samples a class;
  2. cli/dump_cams.py at stage 1's best-localization snapshot;
  3. stage 2: cli/train.py --task TCAM with the script's flags (20 epochs,
     1000 seeds, the landmark CRF) over the dumped store, from stage 1's
     best-classification encoder and head;
  4. cli/evaluate.py at stage 2's best-localization snapshot on test:
     once at the trainer's cam_curve_interval and eval batch, held
     against the trainer's own test pass (the gap recorded), and once at
     cam_curve_interval 0.001, the script's final number.
Both stages share --seed, as in the script; the set is the same for
every seed.  Every CLI gets the script's COMMON data flags: --h2d_transfer
uint8 (uint8 pixels and packed CAM planes; the dump normalizes as the JAX
dump does under it) and --decode_cache_mb 768 (decoded frames kept on the
card across epochs); --num_workers 4 is kept.  As in JAX, cli/evaluate.py
takes float pixels and no cache whatever those flags say, so its gap to
the trainer's test pass (rounded pixels) is recorded, not assumed to be
0.  The compute dtypes are the JAX defaults (bf16 train steps and dump,
fp32 eval) unless --compute_dtype says otherwise.

Each run prints its phases, writes chiprun_out/dress_<dtype>_seed<seed>.json
and ends with one JSON line of its test MaxBoxAcc.  --summarize prints
every record's numbers and, per compute dtype, the spread over seeds.
Without CUDA a run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the set of cmds/e2e_dress_rehearsal_tpu.sh
DATA = dict(n_classes=10, n_videos_per_class=8, n_shots_per_video=5,
            n_frames_per_shot=8, frame_hw=(256, 320))
EPOCHS = (10, 20)
IOUS = (30, 50, 70)

# the data flags of the script's COMMON line, for every CLI
DATA_FLAGS = ["--h2d_transfer", "uint8", "--decode_cache_mb", "768",
              "--num_workers", "4"]
# the script's flags, stage by stage (paths, seed, sizes and epochs are
# filled in by run())
STAGE1_FLAGS = [
    "--task", "STD_CL", "--batch_size", "32", "--eval_batch_size", "64",
    "--lr", "0.01", "--cam_curve_interval", "0.004",
    "--num_val_sample_per_class", "20", "--checkpoint_save", "0"]
STAGE2_FLAGS = [
    "--task", "TCAM", "--arch", "UnetTCAM", "--batch_size", "32",
    "--eval_batch_size", "64", "--lr", "0.01", "--cam_curve_interval",
    "0.004", "--num_val_sample_per_class", "20", "--elb_init_t", "1.0",
    "--elb_max_t", "10.0", "--elb_mulcoef", "1.01", "--sl_tc", "True",
    "--sl_tc_lambda", "1.0", "--sl_tc_min", "1000", "--sl_tc_max", "1000",
    "--sl_tc_ksz", "3", "--sl_tc_max_p", "0.6", "--sl_tc_min_p", "0.1",
    "--sl_tc_seed_tech", "seed_weighted", "--sl_tc_use_roi", "True",
    "--sl_tc_roi_method", "roi_all", "--sl_tc_roi_min_size", "0.05",
    "--sl_tc_knn", "1", "--sl_tc_knn_mode", "before", "--sl_tc_knn_t", "0.0",
    "--crf_tc", "True", "--crf_tc_lambda", "2e-9", "--crf_tc_sigma_rgb",
    "15.0", "--crf_tc_sigma_xy", "100.0", "--crf_tc_scale", "1.0",
    "--max_sizepos_tc", "True", "--max_sizepos_tc_lambda", "0.01",
    "--checkpoint_save", "0", "--crf_impl", "landmarks"]
FINAL_INTERVAL = "0.001"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def _box(res: Dict) -> Dict[str, float]:
    return {str(s): res[f"maxboxacc_{s}"] for s in IOUS}


def _trainer_record(out: Dict, seconds: float) -> Dict:
    """A cli/train.main run: per epoch the wall, step and data-wait
    medians and the loss; per eval pass its scores; the test passes."""
    train = out["records"]["train"]
    evals = out["records"]["eval"]
    return {
        "seconds": seconds,
        "epochs": [{k: r[k] for k in (
            "epoch", "steps", "wall_ms", "median_step_ms",
            "data_wait_ms_per_step", "loss", "classification",
            "data_route", "data_pixels_ms_per_step", "data_cams_ms_per_step",
            "cache_hits", "cache_misses")}
            for r in train],
        "median_step_ms": statistics.median(r["median_step_ms"]
                                            for r in train),
        "median_data_wait_ms": statistics.median(
            r["data_wait_ms_per_step"] for r in train),
        "val": [{"epoch": e["epoch"], "localization": e["localization"],
                 "classification": e["classification"], **_box(e)}
                for e in evals if e["split"] == "val"],
        "test": {tag: {"localization": r["localization"],
                       "classification": r["classification"],
                       "n_images": r["n_images"], **_box(r)}
                 for tag, r in out["test"].items()},
    }


def _print_trainer(tag: str, rec: Dict) -> None:
    for e in rec["epochs"]:
        print(f"[{tag} epoch {e['epoch']}] wall {e['wall_ms']:.1f} ms, "
              f"{e['steps']} steps, median step {e['median_step_ms']:.2f} "
              f"ms, data wait {e['data_wait_ms_per_step']:.2f} ms/step "
              f"(pixels {e['data_pixels_ms_per_step']:.2f}, CAM side "
              f"{e['data_cams_ms_per_step']:.2f}; {e['data_route']}, cache "
              f"hits/misses {e['cache_hits']}/{e['cache_misses']}); "
              f"loss {e['loss']:.6g}, train classification "
              f"{e['classification']:.2f}", flush=True)
    for v in rec["val"]:
        print(f"[{tag} val epoch {v['epoch']}] localization "
              f"{v['localization']:.2f} classification "
              f"{v['classification']:.2f}", flush=True)
    for snap, t in rec["test"].items():
        print(f"[{tag} test {snap}] MaxBoxAcc 30/50/70 " + "/".join(
            f"{t[str(s)]:.2f}" for s in IOUS) + f" ({t['n_images']} images)"
            f", classification {t['classification']:.2f}", flush=True)
    print(f"[{tag}] {rec['seconds']:.1f} s; medians over epochs: step "
          f"{rec['median_step_ms']:.2f} ms, data wait "
          f"{rec['median_data_wait_ms']:.2f} ms/step", flush=True)


def run(seed: int, compute_dtype: str, workdir: str, device: str = "cuda",
        data: Dict = None, epochs=EPOCHS, crop: int = 224,
        resize: int = 256) -> Dict:
    """One seed of the chain; returns its record (see the module doc)."""
    import torch

    from tcam_wsol_video_tpu_torch.cli import dump_cams as cli_dump
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_eval
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    from tcam_wsol_video_tpu_torch.core import constants
    from tcam_wsol_video_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from tcam_wsol_video_tpu_torch.ops.cuda import bilateral, landmarks

    counters = {"bilateral_exact": bilateral.counts,
                "knm_build": landmarks.knm_counts,
                "nystrom_rhs": landmarks.rhs_counts,
                "nystrom_out": landmarks.out_counts}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    data = data or DATA
    shutil.rmtree(workdir, ignore_errors=True)
    rec: Dict = {"seed": seed, "compute_dtype": compute_dtype,
                 "device": nvidia_smi() if device == "cuda" else device,
                 "torch": torch.__version__, "data": dict(data),
                 "epochs": list(epochs)}
    t0 = time.perf_counter()
    make_synthetic_dataset(workdir, seed=0, device=device, **data)
    rec["data_s"] = time.perf_counter() - t0
    print(f"[data] {data} written in {rec['data_s']:.1f} s", flush=True)

    outd = os.path.join(workdir, "exps")
    store = os.path.join(workdir, "cam_store")
    common = ["--dataset", "YouTube-Objects-v1.0", "--data_root", workdir,
              "--metadata_root", os.path.join(workdir, "folds"),
              "--crop_size", str(crop), "--resize_size", str(resize),
              *DATA_FLAGS, "--seed", str(seed), "--compute_dtype",
              compute_dtype, "--device", device]
    t_chain = time.perf_counter()

    # stage 1
    t0 = time.perf_counter()
    s1 = cli_train.main(common + STAGE1_FLAGS + [
        "--max_epochs", str(epochs[0]), "--outd", outd, "--exp_id", "s1"])
    sync()
    rec["stage1"] = _trainer_record(s1, time.perf_counter() - t0)
    _print_trainer("stage 1", rec["stage1"])

    # the handoff
    dump = cli_dump.main(common + ["--task", "STD_CL", "--exp_dir",
                                   s1["outd"], "--out", store])
    sync()
    rec["dump"] = {k: dump[k] for k in ("step", "n_frames", "seconds",
                                        "frames_per_s", "host_s")}
    print(f"[dump] {dump['n_frames']} frames of the best_localization "
          f"snapshot (step {dump['step']}) in {dump['seconds']:.2f} s: "
          f"{dump['frames_per_s']:.1f} frames/s", flush=True)

    # stage 2, its launches counted
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    s2 = cli_train.main(common + STAGE2_FLAGS + [
        "--max_epochs", str(epochs[1]), "--folder_pre_trained_cl",
        s1["outd"], "--std_cams_folder", store, "--outd", outd, "--exp_id",
        "s2"])
    sync()
    rec["stage2"] = _trainer_record(s2, time.perf_counter() - t0)
    rec["stage2"]["launches"] = {n: {"kernel": c.kernel, "plain": c.plain}
                                 for n, c in counters.items()}
    rec["stage2"]["steps"] = sum(e["steps"] for e in rec["stage2"]["epochs"])
    _print_trainer("stage 2", rec["stage2"])
    print(f"[stage 2] launches in {rec['stage2']['steps']} steps: "
          f"{rec['stage2']['launches']}", flush=True)

    # evaluate at stage 2's best-localization snapshot
    ev_flags = common + ["--task", "TCAM", "--arch", "UnetTCAM",
                         "--exp_dir", s2["outd"], "--split", "test"]
    t0 = time.perf_counter()
    same = cli_eval.main(ev_flags + ["--cam_curve_interval", "0.004",
                                     "--eval_batch_size", "64"])
    t1 = time.perf_counter()
    final = cli_eval.main(ev_flags + ["--cam_curve_interval",
                                      FINAL_INTERVAL])
    t2 = time.perf_counter()
    trainer = rec["stage2"]["test"][constants.BEST_LOC]
    one_image = 100.0 / trainer["n_images"]
    gap = {str(s): abs(same[f"maxboxacc_{s}"] - trainer[str(s)])
           for s in IOUS}
    rec["evaluate"] = {"same_interval": _box(same), "gap_to_trainer": gap,
                       "matches_trainer": max(gap.values()) <= one_image,
                       "same_interval_s": t1 - t0,
                       "final": {**_box(final), "interval": FINAL_INTERVAL,
                                 "best_tau": final["best_tau"],
                                 "n_images": final["n_images"]},
                       "final_s": t2 - t1}
    rec["chain_s"] = time.perf_counter() - t_chain
    print(f"[evaluate] at the trainer's interval 0.004: MaxBoxAcc "
          + "/".join(f"{same[f'maxboxacc_{s}']:.2f}" for s in IOUS)
          + f", |evaluate - trainer| " + "/".join(
              f"{g:.4f}" for g in gap.values())
          + f" (one image {one_image:.4f}; evaluate reads float pixels, "
          f"the trainer's test pass rounded ones): within one image "
          f"{rec['evaluate']['matches_trainer']}", flush=True)
    print(f"[evaluate] at interval {FINAL_INTERVAL}: MaxBoxAcc "
          + "/".join(f"{final[f'maxboxacc_{s}']:.2f}" for s in IOUS)
          + f" on {final['n_images']} images ({t2 - t1:.1f} s); the chain "
          f"{rec['chain_s']:.1f} s", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return rec


def summarize(paths: Sequence[str]) -> Dict:
    """Per compute dtype: each seed's test MaxBoxAcc of both stages and
    the final evaluate, the epoch walls and medians, and the mean, min,
    max and standard deviation over seeds."""
    recs: Dict[str, List[Dict]] = {}
    for p in sorted(paths):
        with open(p) as f:
            r = json.load(f)
        recs.setdefault(r["compute_dtype"], []).append(r)
    out = {}
    for dtype, rs in sorted(recs.items()):
        rows = {}
        for r in sorted(rs, key=lambda r: r["seed"]):
            row = {}
            for st in ("stage1", "stage2"):
                for s in IOUS:
                    row[f"{st}_{s}"] = r[st]["test"]["best_localization"][
                        str(s)]
                walls = [e["wall_ms"] / 1e3 for e in r[st]["epochs"]]
                row[f"{st}_epoch_s"] = (min(walls), max(walls))
                row[f"{st}_step_ms"] = r[st]["median_step_ms"]
                row[f"{st}_data_wait_ms"] = r[st]["median_data_wait_ms"]
            for s in IOUS:
                row[f"final_{s}"] = r["evaluate"]["final"][str(s)]
            row["evaluate_matches_trainer"] = r["evaluate"][
                "matches_trainer"]
            row["chain_s"] = r["chain_s"]
            rows[r["seed"]] = row
            print(f"[{dtype} seed {r['seed']}] {r['device']}: stage 1 "
                  + "/".join(f"{row[f'stage1_{s}']:.2f}" for s in IOUS)
                  + ", stage 2 " + "/".join(f"{row[f'stage2_{s}']:.2f}"
                                            for s in IOUS)
                  + ", evaluate@" + FINAL_INTERVAL + " " + "/".join(
                      f"{row[f'final_{s}']:.2f}" for s in IOUS)
                  + f" (matches the trainer: "
                  f"{row['evaluate_matches_trainer']}); epochs "
                  f"{row['stage1_epoch_s'][0]:.1f}-"
                  f"{row['stage1_epoch_s'][1]:.1f} s / "
                  f"{row['stage2_epoch_s'][0]:.1f}-"
                  f"{row['stage2_epoch_s'][1]:.1f} s, step "
                  f"{row['stage1_step_ms']:.2f} / {row['stage2_step_ms']:.2f}"
                  f" ms, data wait {row['stage1_data_wait_ms']:.2f} / "
                  f"{row['stage2_data_wait_ms']:.2f} ms; chain "
                  f"{row['chain_s']:.1f} s", flush=True)
        spread = {}
        for key in [f"{st}_{s}" for st in ("stage1", "stage2", "final")
                    for s in IOUS]:
            vals = [row[key] for row in rows.values()]
            spread[key] = {"mean": statistics.fmean(vals), "min": min(vals),
                           "max": max(vals),
                           "std": statistics.pstdev(vals)}
        print(f"[{dtype}] {len(rows)} seeds; test MaxBoxAcc 30/50/70 mean "
              f"(min-max, population std): " + "; ".join(
                  f"{k} {v['mean']:.2f} ({v['min']:.2f}-{v['max']:.2f}, "
                  f"{v['std']:.2f})" for k, v in spread.items()), flush=True)
        out[dtype] = {"seeds": rows, "spread": spread}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--summarize", nargs="+", metavar="RECORD",
                    help="print the spread of these records and exit")
    a = ap.parse_args(argv)
    if a.summarize:
        print(json.dumps(summarize(a.summarize)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_dress_rehearsal: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    print(f"[device] {nvidia_smi()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    rec = run(a.seed, a.compute_dtype, os.path.join(ROOT, "build", "dress"))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out",
                        f"dress_{a.compute_dtype}_seed{a.seed}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    launches = rec["stage2"]["launches"]
    ok = (all(c["plain"] == 0 for c in launches.values())
          and launches["knm_build"]["kernel"] >= rec["stage2"]["steps"])
    print(nvidia_smi())
    print(json.dumps({
        "seed": a.seed, "compute_dtype": a.compute_dtype,
        "stage1": rec["stage1"]["test"]["best_localization"],
        "stage2": rec["stage2"]["test"]["best_localization"],
        "evaluate": rec["evaluate"]["final"],
        "evaluate_matches_trainer": rec["evaluate"]["matches_trainer"],
        "kernels_only": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
