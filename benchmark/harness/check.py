"""The comparison that decides `correct` for a training cell.

The window drives Trainer.train_epoch.  Set-up drove the same trainer
through its warm-up epoch, and StepTap copied what its first three steps
were given and what they left.  The reference, after the window, redoes:

- the data plane, from the benchmark's own frames and CAMs
  (reference/data.py): per row of the three batches its label, its
  pixels (`pixels`: the worst row's mean |luma difference| in levels;
  the program decodes the JPEGs the reference never reads, so this
  number holds the decoder's loss too) and, for TCAM, its seed CAM
  (`cam`: the largest |difference|) and the ROI of the CAM it holds
  (`roi`: the worst row's share of pixels that differ, at the reference's
  Otsu threshold or a bin either side); and `rows`, the frames the steps
  report they trained against the batches' rows (exact);
- the three train steps, from the benchmark's weights, in fp32 with TF32
  off (reference/step.py), on the program's batches and seeder noise
  (the data plane is checked apart above; a ROI pixel on the Otsu
  threshold that flips between two exact computations would otherwise
  move a seed): `loss1`, the largest relative gap of a loss term at
  the first step, where both sides start from the same weights, and
  `loss` over the three steps; `crf1`, the CRF term's at the first step
  (TCAM: kernel 1); `grad`, the worst leaf's gap between the norms of
  the first gradient as the optimizer got it (its momentum after step 1,
  g + wd p0); `update`, the worst leaf's gap between the norms of the
  parameters' change over the three steps; `*_median`, the median
  leaf's; `head_bias1` (stage 1), the norm of the difference of the
  classification head's bias in that first gradient, the batch mean of
  softmax - one-hot: the first step's logits.  A leaf's number is taken
  against the larger of its reference norm and the median leaf's.
  Leaves whose reference gradient is under a thousandth of the median
  nonzero leaf's (the frozen classifier of TCAM) are left out.  Which
  numbers a cell holds, and their limits: benchmark/limits/<cell>.json.

Calibration only (`run.py --calibrate 1`), each in the program's place:
- the control, the reference one precision down, the configuration's
  train steps being bfloat16: its steps in fp8 (e4m3), operands,
  activations and the gradients that reach each layer's output
  (reference/precision.py);
- the data plane's control, apart: pixels at 4 bits (the high nibble of
  each 8-bit level), CAMs and ROIs in bfloat16;
- the witness: the reference's steps in bfloat16 the same way, which
  shows what the configuration's own precision does to each number;
- the planted faults: half of each batch left out (the reference on the
  first half of each batch; and the forward over every row with the
  loss terms over the first half), and (TCAM) the program's ROIs
  inverted."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import data as ref_data
from benchmark.reference import model as ref_model
from benchmark.reference import step as ref_step

LEAF_RULE = 1e-3
CRF_TERM = "con_ran_field_tcams"
HEAD_BIAS = "classification_head.fc.bias"
ALTERNATES = ("control", "witness_bf16", "fault_half_batch",
              "fault_half_loss")


def program_batch(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The planes of a batch as the step received it, in plain form."""
    out = {"label": b["label"].long()}
    out["raw"] = (b["raw_u8"] if "raw_u8" in b else b["raw_img"]).float()
    if "std_cam_u16" in b:
        u16 = b["std_cam_u16"].view(torch.int16).to(torch.int32) & 0xFFFF
        out["std_cam"] = u16.float() / 65535.0
    elif "std_cam" in b:
        out["std_cam"] = b["std_cam"].float()
    if "roi" in b:
        out["roi"] = b["roi"].to(torch.int32)
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep,
             median: bool = False) -> float:
    """The worst (or the median) leaf's |prog norm - ref norm| over the
    larger of its ref norm and the median leaf's ref norm."""
    if not keep:
        return 0.0
    floor = float(np.median([ref[k] for k in keep]))
    gaps = [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30)
            for k in keep]
    return float(np.median(gaps)) if median else max(gaps)


def counted_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    g = _norms(grad)
    nonzero = [v for v in g.values() if v > 0]
    if not nonzero:
        return []
    med = float(np.median(nonzero))
    return [k for k, v in g.items() if v >= LEAF_RULE * med]


def leaf_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep, leaf: str) -> float:
    """|prog - ref| norm of one leaf over the larger of its ref norm and
    the median counted leaf's ref norm (a leaf that `prog` lacks counts as
    zero)."""
    rn = _norms({k: ref[k] for k in keep})
    floor = float(np.median(list(rn.values())))
    gap = (float((prog[leaf].double().cpu() - ref[leaf].double().cpu())
                 .norm()) if leaf in prog else rn[leaf])
    return gap / max(rn[leaf], floor, 1e-30)


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep) -> list:
    """The three leaves of the largest gaps (calibration's look)."""
    floor = float(np.median([ref[k] for k in keep])) if keep else 0.0
    gaps = sorted(((abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor,
                                                          1e-30), k,
                    prog.get(k, 0.0), ref[k]) for k in keep), reverse=True)
    return gaps[:3]


def dump(run: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> dict:
    """Calibration's record of a run against the reference: its terms per
    step and, per counted leaf, [first-gradient norm, |its difference from
    the reference's|, three-step change norm, |its difference|]."""
    keep = counted_leaves(ref["grad"])
    out = {}
    for k in keep:
        m = run["momentum"][k].double().cpu() if k in run["momentum"] \
            else torch.zeros_like(p0[k], dtype=torch.float64)
        rm = ref["first_momentum"][k].double().cpu()
        c = run["params"][k].double().cpu() - p0[k].double().cpu()
        rc = ref["params"][k].double().cpu() - p0[k].double().cpu()
        out[k] = [float(m.norm()), float((m - rm).norm()), float(c.norm()),
                  float((c - rc).norm())]
    return {"terms": run["terms"], "leaves": out}


def step_numbers(run: dict, ref: dict, p0: Dict[str, torch.Tensor],
                 look: bool = False) -> Dict[str, object]:
    """run: {'terms': [per step {name: value}], 'momentum', 'params'}.
    loss1: the largest relative gap of a term at the first step, where
    both sides start from the same weights; loss: over the three steps;
    crf1: the CRF term's relative gap at the first step (TCAM); grad,
    update: the worst leaf's gap between norms; *_median: the median
    leaf's; head_bias1: the norm of the difference of the classification
    head's bias in the first gradient (stage 1: the batch mean of
    softmax - one-hot, the first step's logits read through the
    optimizer).  look: add the terms and leaves behind each number."""
    loss, loss1, crf1, terms = 0.0, 0.0, None, []
    for i, (pt, rt) in enumerate(zip(run["terms"], ref["terms"])):
        for k, rv in rt.items():
            gap = abs(pt.get(k, float("nan")) - rv) / max(abs(rv), 1e-12)
            gap = gap if np.isfinite(gap) else float("inf")
            loss = max(loss, gap)
            if i == 0:
                loss1 = max(loss1, gap)
                if k == CRF_TERM:
                    crf1 = gap
            terms.append((gap, i, k, pt.get(k), rv))
    keep = counted_leaves(ref["grad"])
    pm, rm = _norms(run["momentum"]), _norms(ref["first_momentum"])

    def change(params):
        return _norms({k: params[k].double().cpu() - p0[k].double().cpu()
                       for k in keep})
    pc, rc = change(run["params"]), change(ref["params"])
    out = {"loss1": loss1, "loss": loss,
           "grad": leaf_gap(pm, rm, keep),
           "grad_median": leaf_gap(pm, rm, keep, median=True),
           "update": leaf_gap(pc, rc, keep),
           "update_median": leaf_gap(pc, rc, keep, median=True)}
    if crf1 is not None:
        out["crf1"] = crf1
    if HEAD_BIAS in keep:
        out["head_bias1"] = leaf_diff(run["momentum"], ref["first_momentum"],
                                      keep, HEAD_BIAS)
    if look:
        out["look"] = {"terms": sorted(terms, reverse=True)[:3],
                       "grad": _worst(pm, rm, keep),
                       "update": _worst(pc, rc, keep), "leaves": len(keep)}
    return out


def data_rows(data: dict, cfg: dict, seed: int, steps: int):
    f = cfg["flags"]
    return ref_data.epoch_plan(
        seed, 0, data["shots"], data["frames_of"], data["labels"],
        int(f["batch_size"]), int(f["resize_size"]), int(f["crop_size"]),
        steps)


def _seed_cam(data, cfg, row, dtype=None):
    f = cfg["flags"]
    args = (data["frames_of"][row["frame"].rsplit("/", 1)[0]], row,
            int(f.get("sl_tc_knn", 0)), f.get("sl_tc_knn_mode", "instant"),
            float(f.get("sl_tc_knn_t", 0.0)), int(f["resize_size"]),
            int(f["crop_size"]))
    if dtype is None:
        return ref_data.seed_cam(data["cams"], *args)
    return seed_cam_lowered(data["cams"], *args, dtype=dtype)


def seed_cam_lowered(cams, frames, row, knn, mode, t, resize, crop,
                     dtype) -> np.ndarray:
    """The seed CAM computed in `dtype` (the control's CAM side)."""
    fused = None
    for fid in (ref_data.neighbours(frames, row["frame"], knn, mode)
                if knn > 0 else [row["frame"]]):
        c = torch.as_tensor(cams[fid]).to(dtype)
        if knn > 0 and t > 0:
            e = torch.exp((c + 1e-6) * t)
            c = e / e.amax()
        fused = c if fused is None else torch.maximum(fused, c)
    mh = torch.as_tensor(ref_model.linear_matrix(fused.shape[0], resize,
                                                 False)).to(dtype)
    mw = torch.as_tensor(ref_model.linear_matrix(fused.shape[1], resize,
                                                 False)).to(dtype)
    full = (mh @ fused @ mw.T).double().numpy()
    return np.clip(ref_data.crop_flip(full, row, crop), 0.0, 1.0)


def roi_gap(roi: np.ndarray, cam: np.ndarray) -> float:
    """The share of pixels where `roi` differs from the ROI of the CAM it
    came with (the CAM is held apart), at the reference's Otsu threshold
    or one of its 256 bins either side: between two exact computations,
    fp32 against fp64, a near tie of the between-class variance moves the
    threshold by a bin and a whole level set of pixels with it."""
    q = cam * 255.0
    x = np.floor(q)
    th = ref_data.otsu_skimage(x)
    step = (x.max() - x.min()) / 256.0
    return min(float((roi != (q >= t)).mean())
               for t in (th - step, th, th + step))


def roi_lowered(cam: np.ndarray, dtype) -> np.ndarray:
    """The ROI with 255 cam, its floor and the comparison in `dtype` (the
    control's ROI)."""
    q = torch.as_tensor(cam).to(dtype) * 255.0
    th = ref_data.otsu_skimage(torch.floor(q).double().numpy())
    return (q.double().numpy() >= th).astype(np.int32)


def data_numbers(batches, plan, data: dict, cfg: dict, control=False
                 ) -> Dict[str, float]:
    """The data plane's numbers over the checked steps; with control, the
    control's own batch in the program's place."""
    f = cfg["flags"]
    resize, crop = int(f["resize_size"]), int(f["crop_size"])
    tcam = cfg["task"] == "TCAM"
    labels = 0
    pixels = cam = roi = 0.0
    for b, rows in zip(batches, plan):
        for r, row in enumerate(rows):
            want = ref_data.pixels(data["frames"][row["frame"]], row, resize,
                                   crop)
            if control:
                got = np.floor(np.round(want) / 16.0) * 16.0
            else:
                got = b["raw"][r].double().numpy()
                labels += int(int(b["label"][r]) != row["label"])
            pixels = max(pixels, float(np.abs(ref_data.luma(got)
                                              - ref_data.luma(want)).mean()))
            if not tcam:
                continue
            want_cam = _seed_cam(data, cfg, row)
            if control:
                got_cam = _seed_cam(data, cfg, row, torch.bfloat16)
                got_roi = roi_lowered(got_cam, torch.bfloat16)
            else:
                got_cam = b["std_cam"][r].double().numpy()
                got_roi = b["roi"][r].numpy()
            cam = max(cam, float(np.abs(got_cam - want_cam).max()))
            roi = max(roi, roi_gap(got_roi, got_cam))
    out = {"labels": float(labels), "pixels": pixels}
    if tcam:
        out.update(cam=cam, roi=roi)
    return out


def loss_cfg(cfg: dict) -> dict:
    f = cfg["flags"]
    return {
        "sl_lambda": float(f.get("sl_tc_lambda", 1.0)),
        "crf_lambda": float(f.get("crf_tc_lambda", 0.0)),
        "crf_sigma_rgb": float(f.get("crf_tc_sigma_rgb", 15.0)),
        "crf_sigma_xy": float(f.get("crf_tc_sigma_xy", 100.0)),
        "size_lambda": float(f.get("max_sizepos_tc_lambda", 0.0)),
        "seeder": {"n_fg": int(f.get("sl_tc_max", 10)),
                   "n_bg": int(f.get("sl_tc_min", 10)),
                   "max_p": float(f.get("sl_tc_max_p", 0.2)),
                   "min_p": float(f.get("sl_tc_min_p", 0.2)),
                   "ksz": int(f.get("sl_tc_ksz", 1)),
                   "ignore": -255,
                   "use_roi": str(f.get("sl_tc_use_roi", "false")).lower()
                   == "true",
                   "weighted": f.get("sl_tc_seed_tech") == "seed_weighted"},
    }


def opt_cfg(cfg: dict) -> dict:
    f = cfg["flags"]
    return {"lr": float(f["lr"]), "momentum": 0.9, "weight_decay": 1e-4,
            "nesterov": True, "lr_classifier_ratio": 10.0,
            "elb_t": float(f.get("elb_init_t", 1.0))}


def reference_steps(cfg, weights, batches, gumbels, device,
                    precision="fp32", rows=None, loss_rows=None) -> dict:
    model = ref_model.build(cfg["task"], int(cfg["flags"]["num_classes"]))
    model.load_state_dict(weights)
    model.to(device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = ref_step.run_steps(
            model, cfg["task"],
            [{k: v.to(device) for k, v in b.items()} for b in batches],
            [g.to(device) if g is not None else None for g in gumbels],
            loss_cfg(cfg), opt_cfg(cfg), precision=precision, rows=rows,
            loss_rows=loss_rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out["grad"] = {k: v.cpu() for k, v in out["grad"].items()}
    out["first_momentum"] = {k: v.cpu()
                             for k, v in out["first_momentum"].items()}
    out["params"] = {k: v.cpu() for k, v in out["params"].items()}
    del model
    return out


def numbers(snap: dict, data: dict, cfg: dict, seed: int, weights,
            device, calibrate: bool = False,
            alternates: Sequence[str] = ALTERNATES) -> Dict[str, object]:
    """{'program': numbers}; with calibrate the leaves and terms behind
    them, the data plane's control's numbers and the numbers of each of
    `alternates`: the control, the bf16 witness and the planted faults."""
    steps = len(snap["batches"])
    batches = [program_batch(b) for b in snap["batches"]]
    gumbels = snap["gumbels"] or [None] * steps
    plan = data_rows(data, cfg, seed, steps)
    p0 = {k: v.cpu() for k, v in weights.items()}
    ref = reference_steps(cfg, weights, batches, gumbels, device)
    prog_run = {"terms": [{k: v for k, v in m.items()
                           if k not in ("loss", "n_correct", "n")}
                          for m in snap["metrics"]],
                "momentum": snap["momentum"], "params": snap["params"]}
    rows = sum(int(b["label"].shape[0]) for b in batches)
    out = {"program": {**data_numbers(batches, plan, data, cfg),
                       **step_numbers(prog_run, ref, p0, look=calibrate),
                       "rows": abs(sum(m["n"] for m in snap["metrics"])
                                   - rows)}}
    if not calibrate:
        return out
    ref_run = {"terms": ref["terms"], "momentum": ref["first_momentum"],
               "params": ref["params"]}
    out["dump"] = {"reference": dump(ref_run, ref, p0),
                   "program": dump(prog_run, ref, p0)}
    half = int(cfg["flags"]["batch_size"]) // 2
    for name, kw, left in (("control", {"precision": "fp8"}, 0),
                           ("witness_bf16", {"precision": "bf16"}, 0),
                           ("fault_half_batch", {"rows": half},
                            rows - steps * half),
                           ("fault_half_loss", {"loss_rows": half}, 0)):
        if name not in alternates:
            continue
        alt = reference_steps(cfg, weights, batches, gumbels, device, **kw)
        run = {"terms": alt["terms"], "momentum": alt["first_momentum"],
               "params": alt["params"]}
        out[name] = {**step_numbers(run, ref, p0, look=True),
                     "rows": float(left)}
        out["dump"][name] = dump(run, ref, p0)
    out["control_data"] = data_numbers(batches, plan, data, cfg,
                                       control=True)
    if cfg["task"] == "TCAM":
        # an answer altered where it is produced: the ROI inverted
        out["fault_roi_inverted"] = {"roi": max(
            roi_gap(1 - b["roi"][r].numpy(), b["std_cam"][r].double()
                    .numpy())
            for b in batches for r in range(b["roi"].shape[0]))}
    return out
