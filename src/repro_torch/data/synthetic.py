"""Deterministic synthetic data pipeline.

Port of ``src/repro/data/synthetic.py``, copied verbatim (numpy only) so
the port and the reference draw byte-identical token streams.

Two generators:

* ``SyntheticLM`` — zipf-distributed token stream (marginals match natural
  text); used by throughput/dry-run paths where content doesn't matter.
* ``bigram_batches`` — tokens drawn from a *learnable* random bigram chain.
  A model trained on it has a known achievable loss (the chain's conditional
  entropy), so convergence benchmarks (Tab 1/2, Fig 6 analogues) can compare
  RGC vs dense SGD optimization quality on equal, reproducible footing.

Everything is seeded and stateless-resumable: batch ``i`` is a pure function
of (seed, i), so a restored checkpoint at step i continues the exact stream
(matches the checkpoint substrate's contract).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, i))
        # zipf over a truncated support, remapped through a seed-stable perm
        ranks = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len))
        ranks = np.clip(ranks, 1, self.vocab_size) - 1
        perm = np.random.default_rng(self.seed).permutation(self.vocab_size)
        return {"tokens": perm[ranks].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def bigram_transition(vocab_size: int, seed: int = 0,
                      concentration: float = 0.3) -> np.ndarray:
    """Row-stochastic transition matrix with entropy well below uniform."""
    rng = np.random.default_rng(seed)
    logits = rng.gumbel(size=(vocab_size, vocab_size)) / concentration
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def bigram_entropy(trans: np.ndarray) -> float:
    """Stationary conditional entropy (nats) — the achievable CE floor."""
    # power-iterate the stationary distribution
    pi = np.full(trans.shape[0], 1.0 / trans.shape[0])
    for _ in range(200):
        pi = pi @ trans
    h = -np.sum(pi[:, None] * trans * np.log(np.maximum(trans, 1e-20)))
    return float(h)


def bigram_batches(vocab_size: int, batch: int, seq_len: int,
                   seed: int = 0) -> Iterator[dict]:
    trans = bigram_transition(vocab_size, seed)
    cum = np.cumsum(trans, axis=1)
    i = 0
    while True:
        rng = np.random.default_rng((seed, i))
        toks = np.empty((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        u = rng.random((batch, seq_len))
        for t in range(1, seq_len):
            rows = cum[toks[:, t - 1]]
            toks[:, t] = (u[:, t, None] < rows).argmax(axis=1)
        yield {"tokens": toks}
        i += 1
