"""Dataset preparation: a raw release -> wsol-done-right folds (port of
cli/build_dataset.py, data/builders.py).

    python -m tcam_wsol_video_tpu_torch.cli.build_dataset yto \\
        --raw_root <YouTube-Objects-v1.0 release> --out folds/YTOv1 \\
        [--version v1.0|v2.2] [--seed 0]
    python -m tcam_wsol_video_tpu_torch.cli.build_dataset ytbb \\
        --csv_train yt_bb_detection_train.csv \\
        --csv_validation yt_bb_detection_validation.csv \\
        --frames_root <frames> --out folds/YTBB [--k_val 3] [--seed 0]

Host only: it reads the JPEG headers and the .mat annotations and writes
text files.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from tcam_wsol_video_tpu_torch.data import builders


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Returns the class -> id map written to class_id.yaml."""
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    yto = sub.add_parser("yto", help="YouTube-Objects v1.0 / v2.2 release")
    yto.add_argument("--raw_root", required=True)
    yto.add_argument("--out", required=True)
    yto.add_argument("--version", default="v1.0", choices=["v1.0", "v2.2"])
    yto.add_argument("--seed", type=int, default=0)

    bb = sub.add_parser("ytbb", help="YouTube-BoundingBoxes detection CSVs")
    bb.add_argument("--csv_train", required=True)
    bb.add_argument("--csv_validation", required=True)
    bb.add_argument("--frames_root", required=True)
    bb.add_argument("--out", required=True)
    bb.add_argument("--k_val", type=int, default=3,
                    help="held-out train videos per class for the val split")
    bb.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)
    if args.cmd == "yto":
        class_id = builders.build_metadata(args.raw_root, args.out,
                                           version=args.version,
                                           seed=args.seed)
    else:
        class_id = builders.build_ytbb_metadata(
            args.csv_train, args.csv_validation, args.frames_root,
            args.out, k_val=args.k_val, seed=args.seed)
    print(f"folds written to {args.out}: {len(class_id)} classes "
          f"{sorted(class_id)}")
    return class_id


if __name__ == "__main__":
    main()
