"""Deterministic synthetic LM data pipeline.

Tokens are produced by a counter-based integer hash (SplitMix64-style) of
(seed, step, position) — fully deterministic, seekable to any step (exact
resume after checkpoint restore), no storage, and identical across hosts so
every data shard can materialize its slice independently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def batch_at(cfg: DataConfig, step: int,
             batch_slice: Optional[Tuple[int, int]] = None
             ) -> Dict[str, np.ndarray]:
    """Materialize the (sliced) batch for ``step``.

    ``batch_slice=(lo, hi)`` returns rows [lo, hi) of the global batch —
    the per-data-shard view.
    """
    lo, hi = batch_slice or (0, cfg.global_batch)
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    cols = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
    key = np.uint64((cfg.seed * 1_000_003
                     + step * 0xD1B54A32D192ED03) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        raw = _splitmix64(key + rows * np.uint64(0x100000001B3) + cols)
    toks = (raw % np.uint64(cfg.vocab_size)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
