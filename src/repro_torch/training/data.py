"""Synthetic LM data pipeline (a copy of ``repro/training/data.py``).

A deterministic, seekable stream of token batches: a mixture of (a) a
Zipf-distributed unigram stream and (b) embedded copy/induction patterns so
a ~100M model shows a clearly decreasing loss within a few hundred steps.
Sharded loading: each data-parallel host slices the global batch.  numpy
only: every ``(step, shard, n_shards)`` gives the reference's batch bit
for bit.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        """Deterministic batch for (step, shard)."""
        rng = np.random.default_rng((self.seed, step, shard))
        b = self.batch // n_shards
        toks = rng.choice(self.vocab, size=(b, self.seq), p=self.p)
        # plant induction patterns: copy a span forward
        span = max(4, self.seq // 16)
        for i in range(b):
            if self.seq >= 2 * span + 2:
                src = rng.integers(0, self.seq // 2 - span)
                dst = rng.integers(self.seq // 2, self.seq - span)
                toks[i, dst:dst + span] = toks[i, src:src + span]
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
