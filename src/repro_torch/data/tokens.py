"""Deterministic, shardable token pipeline.

A *stateless* index→batch mapping (hash-based synthetic corpus with
Zipf-ish marginals and local structure): batch ``i`` is a pure function
of ``(seed, i)``, so
  * restore-from-checkpoint resumes the stream exactly (store only the
    step counter — the paper-grade journal/replay property),
  * every data-parallel host computes only its shard: ``host_id/num_hosts``
    slice the batch dim with no coordination.

Real deployments swap ``_synthesize`` for a tokenized shard reader; the
index discipline (below) is the part that matters at 1000 nodes.

Port of ``repro/data/tokens.py``, as it stands (numpy, no download): the
same ``(seed, index, row)`` gives the same tokens in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def _phash(*ints: int) -> np.uint64:
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        h = np.uint64(0x9E3779B97F4A7C15)
        for v in ints:
            h ^= np.uint64(v) + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2))
            h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Local shard of global batch ``index`` → {tokens, labels}."""
        b = self.local_batch
        out = np.empty((b, self.seq_len + 1), np.int32)
        for r in range(b):
            gr = self.host_id * b + r
            out[r] = self._synthesize(index, gr)
        return {"tokens": out[:, :-1], "labels": out[:, 1:].copy()}

    def _synthesize(self, index: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(int(_phash(self.seed, index, row)))
        n = self.seq_len + 1
        # Zipf-ish unigrams with short repeated motifs (gives a learnable
        # next-token structure so loss visibly decreases)
        base = rng.zipf(1.3, size=n).astype(np.int64)
        toks = (base - 1) % self.vocab_size
        n_motif = max(n // 64, 1)
        starts = rng.integers(0, max(n - 16, 1), size=n_motif)
        motif = rng.integers(0, self.vocab_size, size=8)
        for s in starts:
            toks[s : s + 8] = motif[: max(0, min(8, n - s))]
        return toks.astype(np.int32)


def make_lm_batch_iter(stream: TokenStream, start_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    i = start_index
    while True:
        yield stream.batch(i)
        i += 1
