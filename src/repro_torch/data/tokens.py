"""Token pipeline for LM training (port of ``repro/data/tokens.py``):
synthetic but structured token streams (an order-1 Markov chain with a
sparse transition table), so a model has signal to fit.

numpy only, drawn exactly as the reference draws, so both packages see
the same streams bit for bit from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int = 4096
    seq_len: int = 512
    batch_size: int = 8
    branching: int = 32       # successors per state -> learnable structure
    seed: int = 0


class MarkovTokens:
    """Order-1 Markov chain with a sparse transition table."""

    def __init__(self, cfg: TokenDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.successors = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching))
        self.rng = rng

    def sample(self, batch: int, length: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty((batch, length), np.int32)
        state = self.rng.integers(0, cfg.vocab_size, batch)
        for t in range(length):
            out[:, t] = state
            pick = self.rng.integers(0, cfg.branching, batch)
            state = self.successors[state, pick]
        return out

    def batches(self, n_steps: int):
        """Yields {tokens, labels} host batches (labels = next token)."""
        cfg = self.cfg
        for _ in range(n_steps):
            seq = self.sample(cfg.batch_size, cfg.seq_len + 1)
            yield {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
