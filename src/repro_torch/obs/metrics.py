"""Consensus telemetry: the part of ``repro.obs.metrics`` the epoch reads.

``ObsConfig`` switches per-round metrics on (any instance; ``None`` keeps
them off).  ``ConsensusMetrics`` holds, with a leading ``(rounds,)`` axis:

* ``disagreement``      -- network disagreement ``mean_k ||x_k - x_bar||^2``
                           after each round, summed over layers: read off the
                           exact path's Gram recurrence (no pass over the D
                           parameters), and on the coded path off each
                           round's output slab (``packing.slab_disagreement``,
                           the reference's ``region_disagreement``);
* ``effective_rounds``  -- cumulative count of rounds that ran: ``r + 1``
                           under a fixed budget, under ``round_tol`` the
                           rounds the adaptive gate let run.

The reference's other fields (per-layer d2 summaries, mixing entropy, wire
bytes, suspicion, ...) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Passing any ``ObsConfig`` to a consensus engine turns metrics on."""


class ConsensusMetrics(NamedTuple):
    disagreement: torch.Tensor
    effective_rounds: torch.Tensor


def stack_metrics(per_round: list[ConsensusMetrics]) -> ConsensusMetrics:
    """Per-round records -> the ``(rounds,)``-leading form."""
    return ConsensusMetrics(*(torch.stack(f) for f in zip(*per_round)))
