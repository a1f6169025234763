"""Wire faults: per-edge message drop and stale-iterate delivery.

Counterpart of ``repro.faults.wire``; both realize from seeded host
tables, bit for bit the reference's (see :mod:`repro_torch.faults.mask` for
the spawn-key tags).

:class:`DropSchedule` wraps a :class:`~repro_torch.core.dynamic.TopologySchedule`:
a dropped message removes the edge for the round, symmetrically, and the
pair falls back on their self weights as under churn.  It is only a
schedule, so every path of both engines runs it with no code of its own,
and its dense (``mixing_stacks``) and sparse (``edge_stacks``) views derive
from the same realized graphs.

:class:`StaleMask` marks per-agent stale *senders*: a stale agent's
neighbours receive its previous-round iterate, which then goes through the
round's attack and codec like a fresh publication.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.dynamic import TopologySchedule
from repro_torch.core.topology import Topology
from repro_torch.faults.mask import _round_rows

__all__ = ["DropSchedule", "StaleMask"]

_DROP_TAG = 3
_STALE_TAG = 4


@dataclasses.dataclass(frozen=True)
class DropSchedule(TopologySchedule):
    """Per-round symmetric message drop over a base schedule: every realized
    edge drops its message with probability ``drop`` each round, drawn per
    ``(seed, t % cycle)`` on spawn-key stream ``(3, t)``."""

    base: TopologySchedule
    drop: float
    seed: int = 0
    cycle: int = 64

    def __post_init__(self):
        if not 0.0 <= self.drop < 1.0:
            raise ValueError(f"drop probability must be in [0, 1), got {self.drop}")
        if self.cycle < 1:
            raise ValueError(f"DropSchedule cycle must be >= 1, got {self.cycle}")

    @property
    def num_agents(self) -> int:
        return self.base.num_agents

    @functools.cached_property
    def _keep_table(self) -> np.ndarray:
        """(cycle, K, K) bool symmetric message-survival masks."""
        K = self.base.num_agents
        out = np.zeros((self.cycle, K, K), dtype=bool)
        for t in range(self.cycle):
            rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(_DROP_TAG, t)))
            keep_u = np.triu(rng.random((K, K)) >= self.drop, k=1)
            out[t] = keep_u | keep_u.T
        return out

    def topology_at(self, t: int) -> Topology:
        base = self.base.topology_at(int(t))
        return Topology(f"drop({base.name})@{int(t)}", base.adjacency & self._keep_table[int(t) % self.cycle])

    def _host_edge_period(self) -> int:
        return math.lcm(self.base._host_edge_period(), self.cycle)


@dataclasses.dataclass(frozen=True)
class StaleMask:
    """Per-agent stale-delivery table: in round ``t`` agent ``k`` is a stale
    sender with probability ``p``, drawn per ``(seed, t % cycle)`` on
    spawn-key stream ``(4, t)``."""

    K: int
    p: float
    seed: int = 0
    cycle: int = 64

    def __post_init__(self):
        if self.K < 1:
            raise ValueError(f"StaleMask needs K >= 1, got {self.K}")
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"stale probability must be in [0, 1), got {self.p}")
        if self.cycle < 1:
            raise ValueError(f"StaleMask cycle must be >= 1, got {self.cycle}")

    @functools.cached_property
    def _table(self) -> np.ndarray:
        out = np.zeros((self.cycle, self.K), dtype=bool)
        for t in range(self.cycle):
            rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(_STALE_TAG, t)))
            out[t] = rng.random(self.K) < self.p
        return out

    def mask_at(self, t: int) -> np.ndarray:
        """Host view: the (K,) bool stale-sender mask of round ``t``."""
        return self._table[int(t) % self.cycle]

    def host_stacks(self, start: int, rounds: int) -> np.ndarray:
        """Host view of a round-set: (rounds, K) bool."""
        return _round_rows(self._table, start, rounds)

    def mask_stacks(self, start: int, rounds: int, device=None) -> torch.Tensor:
        """Device view of a round-set: :meth:`host_stacks` on ``device``."""
        return torch.as_tensor(self.host_stacks(start, rounds), device=device)
