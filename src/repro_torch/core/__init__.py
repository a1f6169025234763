"""Topologies, DRT weights, packing, schedules, consensus and the
decentralized trainer."""
from repro_torch.core.consensus import (
    PermuteConsensus,
    exchange_decomposition,
    gather_consensus_rounds,
    matching_decomposition,
    permutation_decomposition,
)
from repro_torch.core.dynamic import (
    ChurnSchedule,
    PeriodicSchedule,
    RandomGossipSchedule,
    RoundPolicy,
    StaticSchedule,
    TopologySchedule,
    make_round_policy,
    make_schedule,
    one_peer_exponential,
    schedule_graph_stats,
)

__all__ = [
    "ChurnSchedule",
    "PeriodicSchedule",
    "PermuteConsensus",
    "RandomGossipSchedule",
    "RoundPolicy",
    "StaticSchedule",
    "TopologySchedule",
    "exchange_decomposition",
    "gather_consensus_rounds",
    "make_round_policy",
    "make_schedule",
    "matching_decomposition",
    "one_peer_exponential",
    "permutation_decomposition",
    "schedule_graph_stats",
]
