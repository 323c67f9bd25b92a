"""Synthetic LM token pipeline.

Deterministic, seekable, shardable token stream — the properties a
production loader needs for fault-tolerant training:
  * `batch_at(step)` is a pure function of (seed, step, shard), so restarts
    resume mid-epoch with no state files and elastic re-sharding is exact;
  * tokens follow a Zipfian unigram mixed with short Markov motifs so the
    loss is learnable (not uniform noise) — smoke tests assert loss drops.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


def _zipf_probs(v: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, v + 1, dtype=np.float64)
    p = 1.0 / r ** alpha
    return p / p.sum()


class SyntheticLM:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab_size)
        # fixed motif table: next-token jump patterns
        rng = np.random.default_rng(cfg.seed)
        self._motif = rng.integers(0, cfg.vocab_size,
                                   size=(min(4096, cfg.vocab_size),))

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic (tokens, labels) for a given step/shard."""
        cfg = self.cfg
        per_shard = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, shard))
        toks = rng.choice(cfg.vocab_size, p=self._probs,
                          size=(per_shard, cfg.seq_len + 1)).astype(np.int32)
        # inject learnable motifs: with p=0.5 the next token is a function
        # of the previous one
        mask = rng.random((per_shard, cfg.seq_len)) < 0.5
        nxt = self._motif[toks[:, :-1] % len(self._motif)]
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
