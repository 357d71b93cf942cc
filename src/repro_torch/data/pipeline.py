"""Deterministic, shardable synthetic token pipeline.

Every batch is a pure function of (seed, step, shard), so:
* all data-parallel shards independently materialize *their slice* of the
  global batch with no data service in the loop;
* after a checkpoint/restart or an elastic re-shard, replaying from the
  agreed step id reproduces the exact token stream — this is the property
  the uBFT-replicated coordinator relies on: ordering (step → data range)
  through consensus makes the input pipeline a deterministic state machine.

The stream is a stationary Markov-ish mixture (not uniform noise) so that
training-loss curves are meaningfully decreasing in the examples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_shards == 0
        self.per_shard = cfg.global_batch // cfg.n_shards

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, shard]))

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        """Returns this shard's slice of the global batch for ``step``."""
        c = self.cfg
        rng = self._rng(step, shard)
        B, S = self.per_shard, c.seq_len
        # structured stream: piecewise-linear token walks + noise → learnable
        base = rng.integers(0, c.vocab, size=(B, 1))
        stride = rng.integers(1, 17, size=(B, 1))
        ramp = (base + stride * np.arange(S + 1)[None, :]) % c.vocab
        noise = rng.integers(0, c.vocab, size=(B, S + 1))
        mask = rng.random((B, S + 1)) < 0.1
        toks = np.where(mask, noise, ramp).astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        shards = [self.batch(step, s) for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([sh[k] for sh in shards], axis=0)
                for k in shards[0]}
