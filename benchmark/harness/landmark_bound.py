"""Kernel 4's least time a step, counted from the cell's shapes alone (as
harness/flops.filter_bound counts kernel 1's), so that it reads the same
however the program builds K.

A landmark step builds K_nm (B, P, M) and K_mm (B, M, M), each entry
exp(-||f_p - f_m||^2 / 2) over D features.  Its least work: reading the
features once (B P D for the pixels, B M D for the landmarks) and writing
both blocks once, at the card's memory rate; and one exponential an
entry on the MUFU.  The least time is the larger.  At the recipe's B 32,
P 224^2, M 1024, D 5 with fp32 K the bytes bound it: 2.01 ms."""
from __future__ import annotations

from benchmark.harness.flops import HBM_BYTES_PER_S, MUFU_RATE

LMK_D = 5


def knm_bound(b: int, p: int, m: int, d: int = LMK_D,
              knm_bytes: int = 4) -> dict:
    """The least time of a step's K_nm and K_mm builds, in ms, with its
    entries and bytes; K_nm stored in `knm_bytes` a value, K_mm in fp32."""
    entries = b * p * m + b * m * m
    written = knm_bytes * b * p * m + 4 * b * m * m
    read = 4 * b * (p + m) * d
    bytes_ms = (written + read) / HBM_BYTES_PER_S * 1e3
    mufu_ms = entries / MUFU_RATE * 1e3
    return {"entries": entries, "bytes": written + read,
            "bytes_ms": bytes_ms, "mufu_ms": mufu_ms,
            "bound_ms": max(bytes_ms, mufu_ms)}
