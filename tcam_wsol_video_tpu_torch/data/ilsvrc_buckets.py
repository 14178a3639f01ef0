"""ILSVRC's bucketed train split (port of data/ilsvrc_buckets.py).

The train metadata is split into nbr_chunks files
`train/train_chunk_{i}.txt`, grouped into buckets of bucket_sz chunks.
Each epoch the trainer trains on one bucket after the other; a
BucketStager runs a stage command before a bucket (e.g. copying its
archives to local disk) and a cleanup command after it.
"""
from __future__ import annotations

import os
import subprocess
from typing import Callable, List, Optional

NBR_CHUNKS_TR_ILSVRC = 240
BUCKET_SZ = 8


def chunk_list(items: List, size: int) -> List[List]:
    return [items[i:i + size] for i in range(0, len(items), size)]


def bucket_image_ids(metadata_root: str, bucket: int,
                     n_chunks: int = NBR_CHUNKS_TR_ILSVRC,
                     bucket_sz: int = BUCKET_SZ) -> List[str]:
    """The image ids of one bucket's chunk files, in order."""
    buckets = chunk_list(list(range(n_chunks)), bucket_sz)
    if not 0 <= bucket < len(buckets):
        raise ValueError(f"bucket {bucket} outside [0, {len(buckets)})")
    ids: List[str] = []
    for i in buckets[bucket]:
        path = os.path.join(metadata_root, "train", f"train_chunk_{i}.txt")
        with open(path) as f:
            ids.extend(ln.strip() for ln in f if ln.strip())
    return ids


def num_buckets(n_chunks: int = NBR_CHUNKS_TR_ILSVRC,
                bucket_sz: int = BUCKET_SZ) -> int:
    return len(chunk_list(list(range(n_chunks)), bucket_sz))


class BucketStager:
    """stage_cmd / cleanup_cmd: bucket -> argv, run (and checked) before
    and after each bucket."""

    def __init__(self,
                 stage_cmd: Optional[Callable[[int], List[str]]] = None,
                 cleanup_cmd: Optional[Callable[[int], List[str]]] = None):
        self.stage_cmd = stage_cmd
        self.cleanup_cmd = cleanup_cmd

    def prepare(self, bucket: int) -> None:
        if self.stage_cmd is not None:
            subprocess.run(self.stage_cmd(bucket), check=True)

    def cleanup(self, bucket: int) -> None:
        if self.cleanup_cmd is not None:
            subprocess.run(self.cleanup_cmd(bucket), check=True)

    def __call__(self, buckets: range):
        """Yields the bucket ids, each between its stage and cleanup."""
        for b in buckets:
            self.prepare(b)
            try:
                yield b
            finally:
                self.cleanup(b)


def shell_stager(stage_tmpl: str, cleanup_tmpl: str) -> BucketStager:
    """The train CLI's stager: each template run by `bash -c` with
    {bucket} substituted; an empty template runs nothing."""
    def cmd(tmpl):
        if not tmpl:
            return None
        return lambda b: ["bash", "-c", tmpl.format(bucket=b)]

    return BucketStager(stage_cmd=cmd(stage_tmpl),
                        cleanup_cmd=cmd(cleanup_tmpl))
