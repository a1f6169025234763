"""Consensus telemetry: the part of ``repro.obs.metrics`` the port reads.

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
                           rounds the adaptive gate let run;
* ``suspicion``         -- ``(K,)`` a round: each agent's received-weight
                           deficit against the Metropolis weights of the
                           round's graph (:func:`suspicion_from_A`); zeros
                           on the permute engine, as in the reference;
* ``byzantine_weight_mass`` -- the honest agents' trust mass landing on
                           masked Byzantine sources
                           (:func:`byzantine_weight_mass`); 0 when no fault
                           mask is on.

The reference's other fields (per-layer d2 summaries, mixing entropy, wire
bytes, ...) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Passing any ``ObsConfig`` to a consensus engine turns metrics on."""


class ConsensusMetrics(NamedTuple):
    disagreement: torch.Tensor
    effective_rounds: torch.Tensor
    suspicion: torch.Tensor
    byzantine_weight_mass: torch.Tensor


def stack_metrics(per_round: list[ConsensusMetrics]) -> ConsensusMetrics:
    """Per-round records -> the ``(rounds,)``-leading form."""
    return ConsensusMetrics(*(torch.stack(f) for f in zip(*per_round)))


def suspicion_from_A(A: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Per-agent received-weight deficit of the mixing weights ``A`` (L, K,
    K) against the Metropolis weights on the same graph: ``support`` (K, K)
    is the round's realized support (> 0 on an edge).  (K,): 0 where the
    network trusts the agent as Metropolis would, towards 1 where it has
    stopped listening to it, negative where it trusts it more; 0 for an
    isolated agent."""
    K = support.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=A.device)
    adj = ((support > 0.0) & ~eye).to(F32)
    deg = adj.sum(0) + 1.0
    M0 = adj / torch.maximum(deg[:, None], deg[None, :])
    recv_m = M0.sum(1)  # off-diagonal mass each agent receives under Metropolis
    recv_a = (A.to(F32) * (~eye).to(F32)).sum(2).mean(0)
    return torch.where(recv_m > 1e-12, (recv_m - recv_a) / torch.clamp(recv_m, min=1e-12), 0.0)


def byzantine_weight_mass(A: torch.Tensor, byz_mask: torch.Tensor) -> torch.Tensor:
    """The share of honest agents' total trust mass (self weight included)
    landing on masked Byzantine sources, averaged over honest receivers and
    layers.  ``A`` (L, K, K) column-stochastic; ``byz_mask`` (K,) bool.
    The denominator is the whole column: clipping defends by moving
    neighbour mass onto the diagonal, which must lower this number."""
    K = byz_mask.shape[0]
    eye = torch.eye(K, dtype=F32, device=A.device)
    a = A.to(F32)
    byz = byz_mask.to(F32)
    num = (a * (1.0 - eye) * byz[None, :, None]).sum(1)  # (L, K): Byzantine mass into k
    frac = (num / torch.clamp(a.sum(1), min=1e-12)).mean(0)
    w = 1.0 - byz  # over honest receivers only
    return (frac * w).sum() / torch.clamp(w.sum(), min=1.0)
