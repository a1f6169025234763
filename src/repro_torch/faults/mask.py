"""Seeded Byzantine-membership tables, host and device views bit-consistent.

Counterpart of ``repro.faults.mask``.  A membership table is drawn once on
the host from ``np.random.SeedSequence(entropy=seed, spawn_key=(2, t))``
into a cached numpy table, bit for bit the reference's; the host view
(:meth:`ByzantineMask.mask_at`) slices it and the device view
(:meth:`ByzantineMask.mask_stacks`) copies the rows of one round-set to the
caller's device, so the mask an attack sees inside a round-set is the one
tests and benchmarks read back on the host.

Spawn-key tags keep the fault streams apart from the schedule streams:
gossip uses ``(t,)``, churn ``(1, t)``, Byzantine membership ``(2, t)``,
message drop ``(3, t)`` and stale delivery ``(4, t)``
(:mod:`repro_torch.faults.wire`).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

__all__ = ["ByzantineMask"]

_BYZ_TAG = 2


def _round_rows(table: np.ndarray, start: int, rounds: int) -> np.ndarray:
    """Rows ``start .. start + rounds - 1`` of a per-round table, modulo its
    cycle."""
    return table[(int(start) + np.arange(rounds)) % table.shape[0]]


@dataclasses.dataclass(frozen=True)
class ByzantineMask:
    """Static or scheduled Byzantine membership over K agents.

    Exactly ``floor(fraction * K)`` agents are Byzantine in every round.
    ``cycle=1`` (the default) keeps one membership for all time; ``cycle >
    1`` re-draws it per round index modulo the cycle (an adversary that
    migrates)."""

    K: int
    fraction: float
    seed: int = 0
    cycle: int = 1

    def __post_init__(self):
        if self.K < 1:
            raise ValueError(f"ByzantineMask needs K >= 1, got {self.K}")
        if not 0.0 <= self.fraction < 1.0:
            raise ValueError(f"byzantine fraction must be in [0, 1), got {self.fraction}")
        if self.cycle < 1:
            raise ValueError(f"ByzantineMask cycle must be >= 1, got {self.cycle}")

    @property
    def n_byzantine(self) -> int:
        return int(np.floor(self.fraction * self.K))

    @cached_property
    def _table(self) -> np.ndarray:
        out = np.zeros((self.cycle, self.K), dtype=bool)
        n = self.n_byzantine
        for t in range(self.cycle):
            rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(_BYZ_TAG, t)))
            out[t, rng.choice(self.K, size=n, replace=False)] = True
        return out

    def mask_at(self, t: int) -> np.ndarray:
        """Host view: the (K,) bool membership of round ``t``."""
        return self._table[int(t) % self.cycle]

    def host_stacks(self, start: int, rounds: int) -> np.ndarray:
        """Host view of a round-set: (rounds, K) bool for rounds ``start ..
        start + rounds - 1``."""
        return _round_rows(self._table, start, rounds)

    def mask_stacks(self, start: int, rounds: int, device=None) -> torch.Tensor:
        """Device view of a round-set: the (rounds, K) bool stack of
        :meth:`host_stacks` on ``device``."""
        return torch.as_tensor(self.host_stacks(start, rounds), device=device)
