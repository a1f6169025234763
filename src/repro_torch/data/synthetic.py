"""Synthetic LM token streams (no real corpora), a numpy copy of the
reference's ``repro/data/synthetic.py``: the same seeds and draws, so the
tokens are the reference's bit for bit.

Tokens are generated from a per-agent Markov-ish process with learnable
structure (a random low-order transition table), so cross-entropy genuinely
decreases during training and per-agent distributions can be made non-IID by
giving each agent a different transition table mixture.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab: int
    seq_len: int
    n_tables: int = 4  # distinct base transition tables
    order: int = 1
    alpha: float = 0.05  # dirichlet concentration; small = peaky = learnable
    v_eff: int = 64  # effective vocab (bigram table stays learnably small)
    seed: int = 0


class SyntheticTokenStream:
    """Deterministic, restartable synthetic token source."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab, cfg.v_eff)  # effective vocab (rest unused — realistic tail)
        self.v_eff = v
        self.tables = rng.dirichlet(
            np.full(v, cfg.alpha), size=(cfg.n_tables, v)
        )  # (T, v, v)

    def batch(self, batch_size: int, agent: int = 0, step: int = 0) -> np.ndarray:
        """(batch_size, seq_len + 1) int32 tokens.  Per-agent non-IID: agent k
        samples from table k mod n_tables."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + agent * 10_007 + step) % (2**63)
        )
        table = self.tables[agent % cfg.n_tables]
        out = np.empty((batch_size, cfg.seq_len + 1), np.int32)
        cur = rng.integers(0, self.v_eff, size=batch_size)
        out[:, 0] = cur
        # vectorized ancestral sampling via inverse-CDF
        cdf = np.cumsum(table, axis=1)
        for t in range(1, cfg.seq_len + 1):
            u = rng.random(batch_size)
            cur = (cdf[cur] < u[:, None]).sum(axis=1).clip(0, self.v_eff - 1)
            out[:, t] = cur
        return out

    def agent_batches(self, batch_size: int, num_agents: int, step: int = 0) -> np.ndarray:
        """(num_agents, batch_size, seq_len + 1) — one non-IID batch per agent."""
        return np.stack(
            [self.batch(batch_size, agent=k, step=step) for k in range(num_agents)]
        )
