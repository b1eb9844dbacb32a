"""Synthetic token pipeline: deterministic, seekable, host-sharded.

A real deployment would read tokenized shards; for the reproduction the
pipeline synthesizes a stationary Zipf-ish token stream deterministically
from (seed, step, host), which is enough for the training loop, the
serving driver, and throughput benchmarks — and it is seekable, so
checkpoint-resume is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Deterministic synthetic batches; ``batch_at(step)`` is random access."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.n_hosts
        # Zipf-ish stationary distribution over the vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_id])
        )
        tokens = rng.choice(
            self.cfg.vocab, size=(self.per_host, self.cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
