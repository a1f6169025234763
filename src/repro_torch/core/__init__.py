"""Topologies, DRT weights, packing, consensus and the decentralized trainer."""
from repro_torch.core.consensus import (
    PermuteConsensus,
    exchange_decomposition,
    matching_decomposition,
    permutation_decomposition,
)

__all__ = [
    "PermuteConsensus",
    "exchange_decomposition",
    "matching_decomposition",
    "permutation_decomposition",
]
