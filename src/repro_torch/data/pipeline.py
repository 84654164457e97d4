"""Deterministic synthetic token pipeline for LM training (port of
`repro.data.pipeline`).

A Zipf-ish Markov token stream a (seed, step, shard): every batch is
addressed by its step and shard, so any worker can make any batch again and
a restart or a rescale does not change the sample stream. It is pure numpy,
and the port keeps its own copy: the batches are `repro`'s bit for bit. The
generator's seed is seed * 1,000,003 + step * 131 + shard in uint64
arithmetic (wrapping), as `repro` computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokenDataset:
    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, batch_size: int, shard: int = 0, n_shards: int = 1):
        """{"tokens", "labels"}: int32 [batch_size / n_shards, seq_len] each,
        this shard's rows; the labels are the tokens shifted by one."""
        if batch_size % n_shards:
            raise ValueError(f"batch {batch_size} is not a multiple of {n_shards} shards")
        b = batch_size // n_shards
        with np.errstate(over="ignore"):
            seed = (np.uint64(self.seed) * np.uint64(1_000_003)
                    + np.uint64(step) * np.uint64(131) + np.uint64(shard))
        rng = np.random.default_rng(seed)
        # a Zipf unigram draw mixed with a shifted copy of itself, so that
        # there is a next-token signal to learn
        z = rng.zipf(1.3, size=(b, self.seq_len + 1)).astype(np.int64)
        toks = np.minimum(z, self.vocab - 1)
        copy_mask = rng.random((b, self.seq_len + 1)) < 0.5
        toks[:, 1:] = np.where(copy_mask[:, 1:], toks[:, :-1], toks[:, 1:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batches(ds: SyntheticTokenDataset, batch_size: int, steps: int, shard: int = 0,
                 n_shards: int = 1) -> Iterator[dict]:
    for step in range(steps):
        yield ds.batch(step, batch_size, shard, n_shards)
