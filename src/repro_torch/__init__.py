"""PyTorch/CUDA port of the DRT decentralized-learning system.

Runs beside the JAX package ``repro`` (the reference) and imports nothing of
it.  Module names mirror ``repro``'s.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live in
``repro_torch.kernels`` (see ``python -m repro_torch.experiment`` for the
paper's experiment, and ``PermuteConsensus`` with ``spmd_run`` for the
neighbour-exchange engine).
"""
from repro_torch.comm.exchange import DistExchange, ThreadExchange, spmd_run
from repro_torch.core.consensus import (
    PermuteConsensus,
    matching_decomposition,
    permutation_decomposition,
)

__all__ = [
    "DistExchange",
    "PermuteConsensus",
    "ThreadExchange",
    "matching_decomposition",
    "permutation_decomposition",
    "spmd_run",
]
