"""Deterministic synthetic token data, host-sharded: a copy of
``repro.data.pipeline``'s ``DataConfig`` and ``TokenDataset`` (numpy only),
so the port trains on the reference's batches bit for bit.

Batch content is a pure function of (seed, step, host): restarts replay
identically and re-sharding changes only which slice a host reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 1_024
    global_batch: int = 8
    seed: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1


class TokenDataset:
    """Synthetic LM corpus: a fixed-seed Zipf-ish token stream with structure
    (repeated n-grams) so that a real model can measurably learn on it."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError("batch must split across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) -> host-local batch."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        # Zipf-distributed tokens with planted bigram structure
        ranks = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        tokens = (ranks % (cfg.vocab_size - 2)) + 2
        # plant deterministic bigrams: token t follows (t*7+3) % vocab 30% of time
        follow = (tokens[:, :-1] * 7 + 3) % (cfg.vocab_size - 2) + 2
        mask = rng.random((self.local_batch, cfg.seq_len)) < 0.3
        tokens[:, 1:] = np.where(mask, follow, tokens[:, 1:])
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def batch_iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
