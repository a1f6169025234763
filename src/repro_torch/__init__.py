"""PyTorch/CUDA port of the DRT decentralized-learning system.

Runs beside the JAX package ``repro`` (the reference) and imports nothing of
it.  Module names mirror ``repro``'s.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live in
``repro_torch.kernels`` (see ``python -m repro_torch.experiment`` for the
paper's experiment, ``PermuteConsensus`` with ``spmd_run`` for the
neighbour-exchange engine, ``make_schedule`` / ``make_round_policy``
for time-varying graphs and adaptive round budgets, and
``repro_torch.faults`` for Byzantine fault injection and trust-robust
consensus, and ``make_train_step`` / ``python -m repro_torch.launch.train``
for decentralized LM training).
"""
from repro_torch.comm.exchange import DistExchange, ThreadExchange, spmd_run
from repro_torch.core.consensus import (
    PermuteConsensus,
    matching_decomposition,
    permutation_decomposition,
)
from repro_torch.core.dynamic import ChurnSchedule, PeriodicSchedule, make_round_policy, make_schedule
from repro_torch.launch.train import TrainState, init_train_state, make_train_many_steps, make_train_step

__all__ = [
    "ChurnSchedule",
    "DistExchange",
    "PeriodicSchedule",
    "PermuteConsensus",
    "ThreadExchange",
    "TrainState",
    "init_train_state",
    "make_round_policy",
    "make_schedule",
    "make_train_many_steps",
    "make_train_step",
    "matching_decomposition",
    "permutation_decomposition",
    "spmd_run",
]
