"""Deterministic hierarchical seeds (port of core/prng.py).

The derivation is a SHA-256 over (seed, *path).  `numpy_rng` matches the
JAX package bit for bit; `key` hands back a `torch.Generator` seeded from
the same digest (torch cannot reproduce jax.random streams, so only the
seed is shared, not the draws).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def _digest(seed: int, path) -> bytes:
    h = hashlib.sha256(int(seed).to_bytes(8, "little", signed=True))
    for p in path:
        h.update(b"/")
        if isinstance(p, str):
            h.update(p.encode())
        else:
            h.update(int(p).to_bytes(8, "little", signed=True))
    return h.digest()


class KeyChain:
    """Deterministic hierarchical seed derivation."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def key(self, *path, device="cuda") -> torch.Generator:
        """kc.key('train', epoch, step) -> a generator for that site."""
        g = torch.Generator(device=device)
        g.manual_seed(self.seed_of(*path))
        return g

    def seed_of(self, *path) -> int:
        """The seed of key(*path)'s generator."""
        d = _digest(self.seed, path)
        return int.from_bytes(d[:8], "little") % (2 ** 63)

    def numpy_rng(self, *path) -> np.random.Generator:
        """Host-side RNG derived from the same tree (bit-equal to the JAX
        package's KeyChain.numpy_rng)."""
        d = _digest(self.seed, path)
        return np.random.default_rng(int.from_bytes(d[:16], "little"))
