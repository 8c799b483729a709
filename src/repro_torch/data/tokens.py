"""Synthetic LM data pipeline: deterministic token streams for train/serve.

Real deployments swap in a tokenized corpus behind the same iterator
protocol; the framework only sees (tokens, targets) arrays. The
stream is seeded per (host, step) so multi-host data parallelism reads
disjoint shards without coordination (each host materializes only its
per-host slice). numpy only: the same seeds give the reference's tokens.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["synthetic_lm_batch", "token_stream"]


def synthetic_lm_batch(batch: int, seq: int, vocab: int, step: int = 0,
                       host: int = 0, dtype=np.int32):
    """One (tokens, targets) pair; targets are tokens shifted left."""
    rng = np.random.default_rng(hash((step, host)) % (2 ** 31))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    return toks[:, :-1].astype(dtype), toks[:, 1:].astype(dtype)


def token_stream(batch: int, seq: int, vocab: int, *, start_step: int = 0,
                 host: int = 0) -> Iterator[tuple]:
    step = start_step
    while True:
        yield synthetic_lm_batch(batch, seq, vocab, step=step, host=host)
        step += 1
