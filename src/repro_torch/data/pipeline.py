"""Deterministic synthetic LM data (counterpart of :mod:`repro.data.pipeline`).

Tokens are a counter-based hash of (seed, step, row, column), so any step's
batch can be made again exactly: a restarted or re-scaled job reads the same
stream from the same step whatever its process count. The hash is the JAX
package's, in the same numpy uint64 arithmetic, so the two packages' streams
are bit-identical. Each process takes its slice of the global batch by its
``torch.distributed`` rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix-style avalanche hash, vectorized."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of the global batch at ``step``: ``{"tokens",
        "labels"}``, int32 numpy arrays (B, seq_len), labels shifted by one."""
        hi = hi if hi is not None else self.global_batch
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        mask = (1 << 64) - 1
        base = np.uint64(
            ((self.seed * 0x9E3779B97F4A7C15) + step * 1_000_003) & mask
        )
        toks = _hash_u32(base + rows * np.uint64(65_537) + cols)
        toks = (toks % np.uint32(self.vocab_size)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _process_group() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group when one is up,
    else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def make_batch_iterator(
    ds: SyntheticLMDataset,
    start_step: int = 0,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Iterator[dict]:
    """Per-process iterator: each process yields its slice of the global
    batch, step after step from ``start_step``."""
    rank, world = _process_group()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    per_host = ds.global_batch // pc
    step = start_step
    while True:
        yield ds.batch_at(step, lo=pi * per_host, hi=(pi + 1) * per_host)
        step += 1
