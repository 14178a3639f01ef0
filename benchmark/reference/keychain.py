"""The data plane's random streams: a SHA-256 over (seed, *path), as the
JAX package's core/prng.py derives them (its numpy_rng is bit-equal)."""
from __future__ import annotations

import hashlib

import numpy as np


def digest(seed: int, path) -> bytes:
    h = hashlib.sha256(int(seed).to_bytes(8, "little", signed=True))
    for p in path:
        h.update(b"/")
        if isinstance(p, str):
            h.update(p.encode())
        else:
            h.update(int(p).to_bytes(8, "little", signed=True))
    return h.digest()


def seed_of(seed: int, *path) -> int:
    """The torch generator seed of a site."""
    return int.from_bytes(digest(seed, path)[:8], "little") % (2 ** 63)


def numpy_rng(seed: int, *path) -> np.random.Generator:
    """The host stream of a site."""
    return np.random.default_rng(int.from_bytes(digest(seed, path)[:16],
                                                "little"))
