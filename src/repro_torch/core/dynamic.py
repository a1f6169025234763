"""Time-varying communication graphs: schedules, their dense and sparse
views, and the per-round-set budget policy.

Counterpart of ``repro.core.dynamic``.  A :class:`TopologySchedule` maps a
global consensus-round index ``t`` (a Python int: the port has no traced
step) to that round's graph, with two views:

* ``mixing_stacks(start_round, rounds, device)``: the per-round ``(C_t,
  metropolis_t)`` as ``(rounds, K, K)`` f32 tensors, which
  ``gather_consensus_rounds`` takes as ``C`` / ``metropolis``;
* ``topology_at(t)``: the realized :class:`Topology` (host numpy), which
  ``PermuteConsensus`` decomposes into exchanges round by round;

and the sparse one, ``edge_stacks(start_round, rounds, device)``: the
padded directed edge lists (``EdgeStacks``) that ``path="edge"`` consumes,
with their Metropolis factorization and the per-destination CSR tables of
the gather-only combine.

Host tables are numpy, realized once per schedule and bit for bit the
reference's: the same ``SeedSequence(entropy=seed, spawn_key=(t,))`` draws
for gossip and ``(1, t)`` for churn, each repeated with period ``cycle``.
A static or periodic schedule's matrices come from ``Topology.c_matrix()``
/ ``.metropolis()`` in float64, cast to f32; any other schedule's from the
realized adjacency in f32 (:func:`c_from_adjacency`,
:func:`metropolis_from_adjacency`).  Churn drops agents (every incident
edge, the self loop kept: a dropped agent keeps its iterate) and edges
(symmetrically).

Directed edges are sorted by (dst, src) (``np.nonzero`` of the adjacency
with dst as the first axis), so each destination's in-edges are
contiguous; padding entries are ``src = dst = 0`` with ``w = 0`` and trail
the real edges.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.topology import Topology, make_topology


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


def c_from_adjacency(adj) -> torch.Tensor:
    """The paper's support matrix C from a (..., K, K) 0/1 adjacency: the
    edges plus the self loops, f32."""
    adj = torch.as_tensor(adj, dtype=torch.float32)
    eye = torch.eye(adj.shape[-1], dtype=torch.float32, device=adj.device)
    return torch.where(eye > 0, 1.0, adj)


def metropolis_from_adjacency(adj) -> torch.Tensor:
    """Metropolis-Hastings weights (eq. 5) from a (..., K, K) 0/1
    adjacency, in f32 in the reference's order of operations.  Doubly
    stochastic; an isolated agent gets the identity column."""
    adj = torch.as_tensor(adj, dtype=torch.float32)
    deg = adj.sum(-1) + 1.0  # n_k counts the self loop
    A = adj / torch.maximum(deg[..., :, None], deg[..., None, :])
    eye = torch.eye(adj.shape[-1], dtype=torch.float32, device=adj.device)
    diag = 1.0 - A.sum(-2)  # column sums (symmetric anyway)
    return A + eye * diag[..., None, :]


class TopologySchedule:
    """A deterministic map from round index to communication graph.

    Subclasses implement :meth:`topology_at` and :meth:`_host_edge_period`;
    the dense (:meth:`mixing_stacks`) and sparse (:meth:`edge_stacks`)
    views derive from them."""

    #: True when every round realizes the same graph (the engines then take
    #: their schedule-free paths).
    static: bool = False

    @property
    def num_agents(self) -> int:
        raise NotImplementedError

    def topology_at(self, t: int) -> Topology:
        """Host realization of round ``t``."""
        raise NotImplementedError

    def _host_edge_period(self) -> int:
        """``topology_at(t)`` repeats with this period."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a host edge period"
        )

    def _adjacency_table(self, start_round: int, rounds: int) -> np.ndarray:
        """(rounds, K, K) f32 0/1 adjacencies of rounds ``start_round ..``."""
        return np.stack(
            [self.topology_at(int(start_round) + r).adjacency for r in range(rounds)]
        ).astype(np.float32)

    def adjacency_at(self, t: int, device=None) -> torch.Tensor:
        """(K, K) f32 0/1 adjacency of round ``t`` on ``device``."""
        return torch.as_tensor(self._adjacency_table(t, 1)[0], device=device)

    def mixing_stacks(self, start_round: int, rounds: int, device=None):
        """``(C_stack, metropolis_stack)``, both ``(rounds, K, K)`` f32 on
        ``device``: the support and Metropolis matrices of rounds
        ``start_round .. start_round + rounds - 1``."""
        adj = torch.as_tensor(self._adjacency_table(start_round, rounds), device=device)
        return c_from_adjacency(adj), metropolis_from_adjacency(adj)

    def edge_counts(self, start_round: int, rounds: int, device=None) -> torch.Tensor:
        """Per-round realized undirected edge counts, ``(rounds,)`` f32."""
        adj = torch.as_tensor(self._adjacency_table(start_round, rounds), device=device)
        return adj.sum((-2, -1)) / 2.0

    # -- sparse (edge-list) view ----------------------------------------------

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
        ts = (int(start_round) + np.arange(rounds)) % src.shape[0]
        return EdgeStacks(*(torch.as_tensor(a[ts], device=device) for a in (src, dst, w)))


@dataclasses.dataclass(frozen=True)
class StaticSchedule(TopologySchedule):
    """The same graph every round; its stacks broadcast the topology's own
    (float64-derived) matrices, so it is bit-identical to the
    schedule-free path."""

    topology: Topology
    static: bool = dataclasses.field(default=True, init=False)

    @property
    def num_agents(self) -> int:
        return self.topology.num_agents

    def topology_at(self, t: int) -> Topology:
        del t
        return self.topology

    def mixing_stacks(self, start_round: int, rounds: int, device=None):
        K = self.topology.num_agents
        return tuple(
            torch.as_tensor(m, dtype=torch.float32, device=device).expand(rounds, K, K)
            for m in (self.topology.c_matrix(), self.topology.metropolis())
        )

    def _host_edge_period(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class PeriodicSchedule(TopologySchedule):
    """Cycle through a topology list: round ``t`` uses
    ``topologies[(t // rounds_per_topology) % len(topologies)]``; each
    phase's matrices from the topology's float64 ones, cast to f32."""

    topologies: tuple
    rounds_per_topology: int = 1

    def __post_init__(self):
        if not self.topologies:
            raise ValueError("PeriodicSchedule needs at least one topology")
        object.__setattr__(self, "topologies", tuple(self.topologies))
        Ks = {t.num_agents for t in self.topologies}
        if len(Ks) != 1:
            raise ValueError(f"topologies disagree on K: {sorted(Ks)}")
        if self.rounds_per_topology < 1:
            raise ValueError("rounds_per_topology must be >= 1")

    @property
    def num_agents(self) -> int:
        return self.topologies[0].num_agents

    def _phase(self, t):
        return (t // self.rounds_per_topology) % len(self.topologies)

    @functools.cached_property
    def _tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(phases, K, K) f32 C and Metropolis tables."""
        return (np.stack([np.asarray(tp.c_matrix(), np.float32) for tp in self.topologies]),
                np.stack([np.asarray(tp.metropolis(), np.float32) for tp in self.topologies]))

    def mixing_stacks(self, start_round: int, rounds: int, device=None):
        phases = self._phase(int(start_round) + np.arange(rounds))
        return tuple(torch.as_tensor(t[phases], device=device) for t in self._tables)

    def topology_at(self, t: int) -> Topology:
        return self.topologies[int(self._phase(int(t)))]

    def _host_edge_period(self) -> int:
        return self.rounds_per_topology * len(self.topologies)


@dataclasses.dataclass(frozen=True)
class RandomGossipSchedule(TopologySchedule):
    """Seeded random gossip: round ``t`` is an Erdos-Renyi ``G(K, p)`` draw,
    deterministic per ``(seed, t % cycle)``; single rounds may be
    disconnected."""

    K: int
    p: float = 0.5
    seed: int = 0
    cycle: int = 64  # draws repeat after this many rounds

    def __post_init__(self):
        if self.K < 2:
            raise ValueError(f"gossip needs K >= 2, got {self.K}")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"gossip edge probability must be in (0, 1], got {self.p}")
        if self.cycle < 1:
            raise ValueError(f"cycle must be >= 1, got {self.cycle}")

    @property
    def num_agents(self) -> int:
        return self.K

    @functools.cached_property
    def _table(self) -> np.ndarray:
        """(cycle, K, K) bool: the realized graph sequence."""
        out = np.zeros((self.cycle, self.K, self.K), dtype=bool)
        for t in range(self.cycle):
            rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(t,)))
            upper = np.triu(rng.random((self.K, self.K)) < self.p, k=1)
            out[t] = upper | upper.T
        return out

    def topology_at(self, t: int) -> Topology:
        return Topology(f"gossip@{int(t)}", self._table[int(t) % self.cycle])

    def _host_edge_period(self) -> int:
        return self.cycle


def one_peer_exponential(K: int) -> PeriodicSchedule:
    """One-peer exponential graphs: round ``t`` pairs agent ``i`` with ``i
    XOR 2^(t mod log2 K)``, perfect matchings cycling through the hypercube
    dimensions."""
    d = K.bit_length() - 1
    if K < 2 or (1 << d) != K:
        raise ValueError(f"one-peer exponential needs K a power of two, got {K}")
    topos = []
    for b in range(d):
        A = np.zeros((K, K), dtype=bool)
        for i in range(K):
            A[i, i ^ (1 << b)] = True
        topos.append(Topology(f"onepeer2^{b}", A))
    return PeriodicSchedule(tuple(topos))


@dataclasses.dataclass(frozen=True)
class ChurnSchedule(TopologySchedule):
    """Per-round agent and edge failures over a base schedule: each round
    every agent drops with probability ``agent_drop`` (every incident edge;
    it keeps its iterate) and every surviving edge with probability
    ``edge_drop`` (symmetrically); deterministic per ``(seed, t % cycle)``.
    Its period is ``lcm(base period, cycle)``."""

    base: TopologySchedule
    agent_drop: float = 0.0
    edge_drop: float = 0.0
    seed: int = 0
    cycle: int = 64  # failure draws repeat after this many rounds

    def __post_init__(self):
        for name in ("agent_drop", "edge_drop"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.cycle < 1:
            raise ValueError(f"cycle must be >= 1, got {self.cycle}")

    @property
    def num_agents(self) -> int:
        return self.base.num_agents

    @functools.cached_property
    def _mask_table(self) -> np.ndarray:
        """(cycle, K, K) bool edge-survival masks: the agent-drop outer
        product AND the symmetric edge-drop keep mask."""
        K = self.base.num_agents
        out = np.zeros((self.cycle, K, K), dtype=bool)
        for t in range(self.cycle):
            # spawn_key (1, t): a stream apart from gossip's (t,)
            rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(1, t)))
            alive = rng.random(K) >= self.agent_drop
            keep_u = np.triu(rng.random((K, K)) >= self.edge_drop, k=1)
            out[t] = (keep_u | keep_u.T) & alive[:, None] & alive[None, :]
        return out

    def topology_at(self, t: int) -> Topology:
        base = self.base.topology_at(int(t))
        adj = base.adjacency & self._mask_table[int(t) % self.cycle]
        return Topology(f"churn({base.name})@{int(t)}", adj)

    def _host_edge_period(self) -> int:
        return math.lcm(self.base._host_edge_period(), self.cycle)


def make_schedule(spec, K: int, *, agent_drop: float = 0.0, edge_drop: float = 0.0,
                  seed: int = 0) -> "TopologySchedule | None":
    """A schedule from a spec (the experiment CLI's ``--schedule``):

        <topology-name>             static graph (e.g. "ring")
        static:<topology-name>      same, explicit
        periodic:<a>,<b>[,...][@n]  cycle the named topologies, n rounds each
        gossip[:p]                  per-round Erdos-Renyi G(K, p) draw
        onepeer                     one-peer exponential matchings

    ``agent_drop`` / ``edge_drop`` > 0 wrap the result in a
    :class:`ChurnSchedule` (``None`` then needs a base).  A ``Topology`` or
    ``TopologySchedule`` passes through (churn-wrapped if asked)."""
    if spec is None:
        sched = None
    elif isinstance(spec, TopologySchedule):
        sched = spec
    elif isinstance(spec, Topology):
        sched = StaticSchedule(spec)
    elif isinstance(spec, str):
        head, _, rest = spec.partition(":")
        if head == "static":
            sched = StaticSchedule(make_topology(rest, K))
        elif head == "periodic":
            names, _, rpt = rest.partition("@")
            topos = tuple(make_topology(n.strip(), K) for n in names.split(",") if n.strip())
            sched = PeriodicSchedule(topos, rounds_per_topology=int(rpt) if rpt else 1)
        elif head == "gossip":
            sched = RandomGossipSchedule(K, p=float(rest) if rest else 0.5, seed=seed)
        elif head == "onepeer":
            sched = one_peer_exponential(K)
        else:
            try:
                sched = StaticSchedule(make_topology(spec, K))
            except KeyError:
                raise ValueError(
                    f"unknown schedule spec {spec!r}; expected a topology name, "
                    "'static:<name>', 'periodic:<a>,<b>[@n]', 'gossip[:p]' or 'onepeer'"
                ) from None
    else:
        raise TypeError(f"cannot build a schedule from {type(spec).__name__}")
    if agent_drop or edge_drop:
        if sched is None:
            raise ValueError("churn (agent/edge drop) needs a base schedule or topology")
        sched = ChurnSchedule(sched, agent_drop=agent_drop, edge_drop=edge_drop, seed=seed)
    if sched is not None and sched.num_agents != K:
        raise ValueError(f"schedule has K={sched.num_agents}, expected {K}")
    return sched


@dataclasses.dataclass(frozen=True)
class RoundPolicy:
    """A round-set's budget: ``max_rounds`` rounds, and with ``tol`` an
    adaptive one: every round still runs its kernels, but once the carried
    disagreement is at or below ``tol`` the round and every later one of
    the set leave the iterate as it is (sticky)."""

    max_rounds: int
    tol: "float | None" = None

    def __post_init__(self):
        if self.max_rounds < 1:
            raise ValueError(f"RoundPolicy needs max_rounds >= 1, got {self.max_rounds}")
        if self.tol is not None and not self.tol > 0.0:
            raise ValueError(f"RoundPolicy needs tol > 0, got {self.tol}")

    @property
    def adaptive(self) -> bool:
        return self.tol is not None


def make_round_policy(spec) -> "RoundPolicy | None":
    """A :class:`RoundPolicy` from a spec (``--rounds-policy``,
    ``TrainerConfig.rounds_policy``): ``fixed:<n>``, ``adaptive:<tol>:<max>``
    or a bare round count; ``None`` and a policy pass through."""
    if spec is None or isinstance(spec, RoundPolicy):
        return spec
    if isinstance(spec, int):
        return RoundPolicy(max_rounds=spec)
    if isinstance(spec, str):
        head, _, rest = spec.partition(":")
        if head == "fixed":
            return RoundPolicy(max_rounds=int(rest))
        if head == "adaptive":
            tol_s, sep, max_s = rest.partition(":")
            if not sep:
                raise ValueError(f"adaptive policy spec {spec!r} needs 'adaptive:<tol>:<max>'")
            return RoundPolicy(max_rounds=int(max_s), tol=float(tol_s))
        if spec.lstrip("+-").isdigit():
            return RoundPolicy(max_rounds=int(spec))
        raise ValueError(
            f"unknown rounds policy spec {spec!r}; expected 'fixed:<n>', "
            "'adaptive:<tol>:<max>' or a bare round count"
        )
    raise TypeError(f"cannot build a round policy from {type(spec).__name__}")


def edge_stacks_from_topology(topology: Topology, rounds: int, device=None) -> EdgeStacks:
    """The topology's edge list broadcast over a round-set."""
    return StaticSchedule(topology).edge_stacks(0, rounds, device)


def max_in_degree_from_topology(topology: Topology) -> int:
    """The ``Dmax`` bound of the CSR combine on a static graph."""
    return StaticSchedule(topology).max_in_degree


def schedule_graph_stats(schedule: TopologySchedule, *, rounds: "int | None" = None,
                         wire_itemsize: int = 1) -> dict:
    """Realized graph statistics over one host period (or its first
    ``rounds`` rounds): ``K``, ``period``, ``E_max``, undirected edge counts
    and degrees (self loop excluded) as min/mean/max, and the dense-vs-edge
    cost ratios of one coded round: flops ``K^2 / mean directed |E|`` and
    bytes per slab element ``12 / (8 + 2 * wire_itemsize)`` (the
    reference's traffic model)."""
    K = schedule.num_agents
    src, dst, w = schedule._edge_table
    P = src.shape[0]
    n = P if rounds is None else min(rounds, P)
    directed = w[:n].sum(axis=1)  # real directed edges per round
    degs = [np.bincount(dst[t][w[t] > 0], minlength=K) for t in range(n)]
    degs = np.stack(degs) if degs else np.zeros((1, K), np.int64)
    mean_directed = float(directed.mean()) if n else 0.0
    return {
        "K": K,
        "period": P,
        "rounds_sampled": n,
        "E_max": int(src.shape[1]),
        "undirected_edges": {
            "min": float(directed.min() / 2.0),
            "mean": mean_directed / 2.0,
            "max": float(directed.max() / 2.0),
        },
        "degree": {"min": int(degs.min()), "mean": float(degs.mean()), "max": int(degs.max())},
        "dense_vs_edge_flop_ratio": float(K * K) / mean_directed if mean_directed else float("inf"),
        "dense_vs_edge_byte_ratio": 12.0 / (8.0 + 2.0 * wire_itemsize),
    }
