"""Consensus round-sets on the flat slab: the exact (no-codec) gather engine.

Counterpart of the exact branch of ``repro.core.consensus``
``gather_consensus_rounds``.  The combine is linear, so a whole round-set
runs on the per-layer (L, K, K) Gram matrices:

1. pack the agent-stacked tree once into the (K, D) slab and take the
   per-layer Gram ``G`` (one batched matmul per group);
2. per round, derive the mixing matrices ``A_t`` (DRT eqs. 12-14 from the
   Gram's distances, or the static Metropolis matrix), advance the Gram
   exactly as ``G' = A_t^T G A_t`` and the accumulated product ``M' = M A_t``;
3. apply ``M`` in ONE combine — the ``slab_combine`` kernel on a CUDA slab,
   its plain PyTorch version on a CPU slab — and unpack once.

Two passes over the D parameters in all, whatever the round count.  With
``obs`` the per-round network disagreement is read off the carried Gram.

Not ported yet (they raise ``NotImplementedError``): wire codecs, the edge
and tree paths, time-varying schedules, momentum, adaptive round budgets,
fault injection, trust reweighting and robust combines.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core import drt as drt_mod
from repro_torch.core import packing
from repro_torch.core.drt import DRTConfig
from repro_torch.kernels.slab_combine import slab_combine
from repro_torch.obs.metrics import ConsensusMetrics, ObsConfig, stack_metrics
from repro_torch.utils.pytree import LayerPartition, Tree, agent_template, tree_leaves

Algorithm = Literal["drt", "classical"]


def combine_slab_kernels(layout: packing.SlabLayout, M: torch.Tensor, slab: torch.Tensor):
    """Whole-slab combine through ``slab_combine``: the per-block (K, K)
    matrices are gathered from the static ``layout.block_layer`` map."""
    A_blocks = M.float()[layout.block_layer_on(M.device)].contiguous()
    return slab_combine(A_blocks, slab)


def gather_consensus_rounds(
    partition: LayerPartition,
    psi_K: Tree,
    C,
    cfg: DRTConfig,
    *,
    rounds: int = 1,
    algorithm: Algorithm = "drt",
    metropolis=None,
    layout: "packing.SlabLayout | None" = None,
    obs: "ObsConfig | None" = None,
    codec=None,
    path: str = "slab",
    momentum: float = 0.0,
    round_tol: float | None = None,
    faults=None,
    trust_clip: float | None = None,
    trust_temp: float | None = None,
    combine: str = "drt",
):
    """``rounds`` exact consensus rounds with one pack and one combine.

    ``psi_K``: agent-stacked tree (leading K on every leaf).  ``C``: the
    (K, K) support matrix; ``metropolis``: the (K, K) classical mixing
    matrix (needed for ``algorithm="classical"``).  Returns ``(new_K,
    A_last)``, or ``(new_K, A_last, metrics)`` with ``obs`` (a
    :class:`~repro_torch.obs.metrics.ConsensusMetrics` with a leading
    ``(rounds,)`` axis).  Runs under ``torch.no_grad``: consensus sits
    outside the gradient.
    """
    _refuse_unported(
        codec=codec is not None and codec != "identity",
        path=path != "slab",
        momentum=momentum != 0.0,
        round_tol=round_tol is not None,
        faults=faults is not None,
        trust_clip=trust_clip is not None,
        trust_temp=trust_temp is not None,
        combine=combine != "drt",
    )
    if rounds < 1:
        raise ValueError(
            f"gather_consensus_rounds needs rounds >= 1, got {rounds}; "
            "skip the call entirely for a consensus-free step"
        )
    if algorithm not in ("drt", "classical"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    L = partition.num_layers
    C = _static_matrix(C, "C", K, device)
    if algorithm == "classical":
        if metropolis is None:
            raise ValueError('algorithm="classical" needs metropolis=')
        metropolis = _static_matrix(metropolis, "metropolis", K, device)
    if layout is None:
        layout = packing.build_slab_layout(partition, agent_template(psi_K))

    with torch.no_grad():
        slab = layout.pack(psi_K)
        need_G = algorithm == "drt" or obs is not None
        G = layout.gram(layout.split(slab)) if need_G else None
        M = torch.eye(K, device=device).expand(L, K, K)
        per_round = []
        for r in range(rounds):
            if algorithm == "classical":
                A = metropolis.expand(L, K, K)
            else:
                d2, n2 = packing.gram_sq_dists(G)
                A = drt_mod.drt_mixing_matrices(d2, n2, C, cfg)
            if need_G:
                G = packing.gram_update(G, A)
            M = torch.bmm(M, A)
            if obs is not None:
                per_round.append(
                    ConsensusMetrics(
                        disagreement=packing.gram_disagreement(G),
                        effective_rounds=torch.tensor(float(r + 1), device=device),
                    )
                )
        new_K = layout.unpack(combine_slab_kernels(layout, M, slab), like=psi_K)
    if obs is None:
        return new_K, A
    return new_K, A, stack_metrics(per_round)


def _static_matrix(mat, name: str, K: int, device) -> torch.Tensor:
    t = torch.as_tensor(mat, dtype=torch.float32, device=device)
    if t.dim() == 3:
        raise NotImplementedError(
            f"per-round {name} stacks (time-varying schedules) are not ported yet"
        )
    if tuple(t.shape) != (K, K):
        raise ValueError(f"{name} must be ({K}, {K}), got {tuple(t.shape)}")
    return t


def _refuse_unported(**flags: bool) -> None:
    on = sorted(name for name, set_ in flags.items() if set_)
    if on:
        raise NotImplementedError(
            f"gather_consensus_rounds: {', '.join(on)} not ported yet; the port "
            "runs exact (no-codec) slab round-sets without control or faults"
        )
