"""The sparse (edge-list) view of a communication graph.

Counterpart of the static-graph edge view of ``repro.core.dynamic``: the
padded directed edge lists (``EdgeStacks``) that ``path="edge"`` consumes,
their Metropolis factorization and the per-destination CSR tables of the
gather-only combine.

Host tables are numpy, realized once per schedule; :meth:`edge_stacks`
hands them to the caller's device.  Directed edges are sorted by (dst, src)
(``np.nonzero`` of the adjacency with dst as the first axis), so each
destination's in-edges are contiguous; padding entries are ``src = dst =
0`` with ``w = 0`` and trail the real edges.

Only the static schedule is ported; the time-varying ones (periodic,
gossip, churn) and the dense ``mixing_stacks`` view are not yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.topology import Topology


class EdgeStacks(NamedTuple):
    """Per-round padded DIRECTED edge lists: every undirected edge {l, k}
    appears as (src=l, dst=k) and (src=k, dst=l), sorted by (dst, src);
    rounds are padded to a common ``E_max`` with ``src = dst = 0, w = 0``
    (inert: every weight is masked on ``w > 0``).  ``w`` is the support
    weight of the edge (the off-diagonal ``C`` entry, 1.0 for every
    built-in topology)."""

    src: torch.Tensor  # (rounds, E_max) int32
    dst: torch.Tensor  # (rounds, E_max) int32
    w: torch.Tensor  # (rounds, E_max) float32; 0.0 marks padding


def metropolis_edge_weights(src, dst, w, K: int):
    """Metropolis-Hastings weights (eq. 5) on a padded directed edge list:
    ``(m_self (K,), m_e (E,))``, ``m_e[e]`` the weight agent ``dst[e]``
    applies to ``src[e]``'s iterate.  Padding gets 0 and an isolated agent
    keeps the identity column.  Sums run in edge-list order, as the
    reference's scatter-adds."""
    mask = (w.float() > 0.0).float()
    dst_l, src_l = dst.long(), src.long()
    deg = torch.ones(K, dtype=torch.float32, device=w.device).index_add_(0, dst_l, mask)
    m_e = torch.where(mask > 0.0, 1.0 / torch.maximum(deg[src_l], deg[dst_l]), 0.0)
    m_self = 1.0 - torch.zeros(K, dtype=torch.float32, device=w.device).index_add_(0, dst_l, m_e)
    return m_self, m_e


def csr_from_edges(src, dst, w, K: int, max_in_degree: int):
    """Per-DESTINATION CSR view of a padded (dst, src)-sorted edge list.

    Returns ``nbr`` (K, Dmax) int32, the source of the j-th in-edge (0 when
    padded); ``pos`` (K, Dmax) int32, that edge's row in the list
    (clipped); ``valid`` (K, Dmax) bool, ``j < in_degree(k)``; ``rank``
    (E,) int32, each edge's slot within its destination's segment.  The
    segment offsets come from two ``searchsorted`` over the destination
    keys with padding remapped past every agent."""
    E = src.shape[0]
    dev = src.device
    mask = w.float() > 0.0
    key = torch.where(mask, dst.long(), K)
    ks = torch.arange(K, device=dev)
    offs = torch.searchsorted(key, ks)
    deg = torch.searchsorted(key, ks, right=True) - offs
    j = torch.arange(max_in_degree, device=dev)
    pos = torch.clamp(offs[:, None] + j[None, :], 0, E - 1)
    valid = j[None, :] < deg[:, None]
    nbr = torch.where(valid, src.long()[pos], 0)
    rank = torch.clamp(
        torch.arange(E, device=dev) - offs[torch.clamp(dst.long(), 0, K - 1)], 0, max_in_degree - 1
    )
    return nbr.int(), pos.int(), valid, rank.int()


class TopologySchedule:
    """A deterministic map from round index to communication graph; the
    port carries its sparse (edge-list) view."""

    def topology_at(self, t: int) -> Topology:
        """Host realization of round ``t``."""
        raise NotImplementedError

    def _host_edge_period(self) -> int:
        """``topology_at(t)`` repeats with this period."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a host edge period"
        )

    @functools.cached_property
    def _edge_table(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(P, E_max) numpy (src, dst, w) tables over one period, (dst,
        src)-sorted, padding trailing."""
        P = self._host_edge_period()
        per_round = []
        for t in range(P):
            adj = np.asarray(self.topology_at(t).adjacency, dtype=bool)
            # np.nonzero walks row-major: with dst as the FIRST axis the
            # edges come out (dst, src)-sorted
            d, s = np.nonzero(adj)
            per_round.append((s.astype(np.int32), d.astype(np.int32)))
        E_max = max(max((len(s) for s, _ in per_round), default=0), 1)
        src = np.zeros((P, E_max), np.int32)
        dst = np.zeros((P, E_max), np.int32)
        w = np.zeros((P, E_max), np.float32)
        for t, (s, d) in enumerate(per_round):
            src[t, : len(s)] = s
            dst[t, : len(d)] = d
            w[t, : len(s)] = 1.0
        return src, dst, w

    @property
    def max_edges(self) -> int:
        """Padded directed edge count ``E_max`` per round."""
        return int(self._edge_table[0].shape[1])

    @property
    def max_in_degree(self) -> int:
        """Bound on any agent's in-degree over the period: the ``Dmax`` of
        the CSR combine."""
        _, dst, w = self._edge_table
        m = 1
        for t in range(dst.shape[0]):
            real = w[t] > 0.0
            if real.any():
                m = max(m, int(np.bincount(dst[t][real]).max()))
        return m

    def edge_stacks(self, start_round: int, rounds: int, device=None) -> EdgeStacks:
        """Per-round padded edge lists of rounds ``start_round ..
        start_round + rounds - 1``, as tensors on ``device``."""
        src, dst, w = self._edge_table
        ts = (start_round + np.arange(rounds)) % src.shape[0]
        return EdgeStacks(*(torch.as_tensor(a[ts], device=device) for a in (src, dst, w)))


@dataclasses.dataclass(frozen=True)
class StaticSchedule(TopologySchedule):
    """The same graph every round."""

    topology: Topology

    def topology_at(self, t: int) -> Topology:
        del t
        return self.topology

    def _host_edge_period(self) -> int:
        return 1


def edge_stacks_from_topology(topology: Topology, rounds: int, device=None) -> EdgeStacks:
    """The topology's edge list broadcast over a round-set."""
    return StaticSchedule(topology).edge_stacks(0, rounds, device)


def max_in_degree_from_topology(topology: Topology) -> int:
    """The ``Dmax`` bound of the CSR combine on a static graph."""
    return StaticSchedule(topology).max_in_degree
