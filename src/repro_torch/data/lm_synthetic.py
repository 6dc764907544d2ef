"""Synthetic-but-learnable LM data: a sparse random Markov chain.

Port of ``repro/data/lm_synthetic.py`` (numpy only, copied so the port
needs nothing of the reference): the same numpy draws give the same
tokens.  Each token has ``branching`` allowed successors with Zipf-ish
weights, so a model that learns the transition table drops from ln(V) to
about H(chain) nats — a real learning signal without an external corpus,
and FL clients with distinguishable dialects (a per-client permutation of
the successor weights makes them non-IID).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class MarkovLM:
    def __init__(self, vocab: int, *, branching: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, (vocab, branching))
        w = 1.0 / np.arange(1, branching + 1)
        self.probs = w / w.sum()
        self.branching = branching

    def entropy(self) -> float:
        return float(-(self.probs * np.log(self.probs)).sum())

    def sample(
        self, rng: np.random.Generator, batch: int, seq: int,
        dialect: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """dialect: optional per-client permutation of successor weights."""
        probs = self.probs if dialect is None else self.probs[dialect]
        out = np.empty((batch, seq), np.int32)
        cur = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            out[:, t] = cur
            choice = rng.choice(self.branching, size=batch, p=probs)
            cur = self.succ[cur, choice]
        return out

    def batch(self, rng, batch: int, seq: int):
        tokens = self.sample(rng, batch, seq + 1)
        return tokens[:, :-1], tokens[:, 1:]
