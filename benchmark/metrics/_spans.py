"""Helpers of the readers over the program's spans and counters: the
`spans` ({name: [count, ms, self ms]}), `counts` and `setup` entries of
the window's per-epoch train records (engine/trainer.py).  A record
without them (a program without the recorder) gives None."""
from __future__ import annotations

MS, SELF_MS = 1, 2


def _recorded(ctx):
    return [r for r in ctx.get("records", []) if "spans" in r and r["steps"]]


def per_step(ctx, name: str, field: int = MS):
    """A span's ms (or self ms) over the window's steps; None where no
    record of the window holds the span."""
    recs = _recorded(ctx)
    if not any(name in r["spans"] for r in recs):
        return None
    return float(sum(r["spans"].get(name, [0, 0.0, 0.0])[field]
                     for r in recs) / sum(r["steps"] for r in recs))


def per_epoch(ctx, name: str, field: int = MS):
    """A span's ms (or self ms) averaged over the window's epochs."""
    recs = [r for r in _recorded(ctx) if name in r["spans"]]
    if not recs:
        return None
    return float(sum(r["spans"][name][field] for r in recs) / len(recs))


def counted(ctx, name: str):
    """A counter summed over the window; None where no record counts it."""
    recs = [r for r in _recorded(ctx) if name in r.get("counts", {})]
    if not recs:
        return None
    return sum(r["counts"][name] for r in recs)


def setup_ms(ctx, names):
    """The ms of the set-up spans `names` (those recorded) before the
    trainer's first epoch; None without a set-up record."""
    recs = [r for r in ctx.get("records", []) if r.get("setup")]
    if not recs:
        return None
    setup = recs[0]["setup"]
    found = [setup[n][MS] for n in names if n in setup]
    return float(sum(found)) if found else None
