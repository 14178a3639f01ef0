"""Experiment log: one line per record on stderr and in <outd>/log.txt,
one JSON object per record in <outd>/log.json (the JAX package's
core/logger.py backends, as an object the trainer owns)."""
from __future__ import annotations

import datetime
import json
import os
import sys
from typing import Any, Dict, Union


class ExpLogger:
    def __init__(self, outdir: str):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)

    def log(self, data: Union[str, Dict[str, Any]], step: Any = None
            ) -> None:
        ts = datetime.datetime.now().isoformat(timespec="seconds")
        if isinstance(data, str):
            line = f"[{ts}] ({step}) {data}"
            payload = {"ts": ts, "step": step, "msg": data}
        else:
            line = f"[{ts}] ({step}) " + " ".join(
                f"{k}={v}" for k, v in data.items())
            payload = {"ts": ts, "step": step, **data}
        print(line, file=sys.stderr, flush=True)
        with open(os.path.join(self.outdir, "log.txt"), "a") as f:
            f.write(line + "\n")
        with open(os.path.join(self.outdir, "log.json"), "a") as f:
            f.write(json.dumps(payload, default=str) + "\n")
