"""Consensus telemetry: the ``ConsensusMetrics`` record and its producers.

Counterpart of ``repro.obs.metrics``.  Both engines emit one record a
round when they are given an :class:`ObsConfig` (any instance; ``obs=None``,
the default, calls no producer of this module), stacked with a leading
``(rounds,)`` axis.  The producers reuse what a round already holds: the
exact path reads the disagreement and the distances off its carried Gram
(no pass over the D parameters), a coded DRT round reads its Gram from
``slab_encode_combine`` and an edge round its per-edge distances from the
edge kernels' stats launch, so telemetry adds no kernel launch on the
gather engine.  Wire bytes are counted at run time from the layout and the
realized wire (top-k counts its nonzeros), not taken from
:mod:`repro_torch.comm.accounting`, so the two cross-check each other.

The producers of per-round statistics take a leading ``(rounds,)`` axis
too (the gather engine makes a round-set's record in one pass).

Fields (f32 tensors on the round-set's device):

``disagreement``
    ``mean_k ||x_k - x_bar||^2`` summed over parameters, after the round.
``layer_d2_mean`` / ``layer_d2_max``  (L,)
    Off-diagonal mean and max of each layer's pairwise squared distances
    before the round's combine (what eqs. 12-14 read); zeros where the
    round has none (classical coded and edge rounds).  The edge path
    reports its edges' distances, the permute engine each agent's own
    neighbours.
``mix_entropy``
    Mean column entropy of the round's mixing matrices in nats (``log K``:
    uniform averaging; 0: every agent keeps its own iterate).
``ef_residual``
    Mean per-agent squared norm of the error-feedback residual after the
    round (top-k; 0 for a stateless codec or the exact exchange).
``wire_send_bytes`` / ``wire_recv_bytes``
    Mean per-agent bytes sent and received in the round: the gather engine
    publishes once and receives ``K - 1`` wires (the edge path its mean
    in-degree's); the permute engine sends and receives one wire an
    exchange.  0 for a round the adaptive gate turned off.
``compression_ratio``
    f32-equivalent bytes over the bytes of one wire (1 on the exact path).
``edges``
    Undirected edges of the round's realized graph.
``effective_rounds``
    Cumulative count of rounds that ran: ``r + 1`` under a fixed budget,
    under ``round_tol`` the rounds the adaptive gate let run.
``momentum_norm``
    Mean per-agent squared norm of the heavy-ball term the round added (0
    without momentum or when the gate turned the round off; the permute
    engine reports its own agent's).
``suspicion``  (K,)
    Each agent's received-weight deficit against the Metropolis weights of
    the round's graph (:func:`suspicion_from_A`); zeros on the permute
    engine.
``byzantine_weight_mass``
    The honest agents' trust mass landing on masked Byzantine sources
    (:func:`byzantine_weight_mass`); 0 without a fault mask.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.comm.codec import CastCodec, IdentityCodec, Int8StochasticCodec, TopKCodec
from repro_torch.utils.pytree import tree_leaves

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Passing any ``ObsConfig`` to a consensus engine turns metrics on.
    ``annotate=True`` also wraps the slab phases (``consensus.pack``,
    ``.encode``, ``.decode``, ``.combine``, ``.unpack``) in profiler
    ranges (:func:`repro_torch.obs.profiling.scope`)."""

    annotate: bool = False


class ConsensusMetrics(NamedTuple):
    """One round's telemetry (module docstring), the reference's fields in
    its order; a leading ``(rounds,)`` axis once stacked."""

    disagreement: torch.Tensor
    layer_d2_mean: torch.Tensor
    layer_d2_max: torch.Tensor
    mix_entropy: torch.Tensor
    ef_residual: torch.Tensor
    wire_send_bytes: torch.Tensor
    wire_recv_bytes: torch.Tensor
    compression_ratio: torch.Tensor
    edges: torch.Tensor
    effective_rounds: torch.Tensor
    momentum_norm: torch.Tensor
    suspicion: torch.Tensor
    byzantine_weight_mass: torch.Tensor


def empty_metrics(num_layers: int, num_agents: int, device=None) -> ConsensusMetrics:
    """A zero-round stack."""
    z = torch.zeros((0,), dtype=F32, device=device)
    zl = torch.zeros((0, num_layers), dtype=F32, device=device)
    zk = torch.zeros((0, num_agents), dtype=F32, device=device)
    return ConsensusMetrics(z, zl, zl, z, z, z, z, z, z, z, z, zk, z)


def stack_metrics(per_round: list) -> ConsensusMetrics:
    """Per-round records -> the ``(rounds,)``-leading form."""
    return ConsensusMetrics(*(torch.stack(f) for f in zip(*per_round)))


# -- distance and weight statistics ----------------------------------------------


def d2_summaries(d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Off-diagonal mean and max per layer of pairwise squared distances
    ``d2 (L, K, K)`` -> two ``(L,)`` tensors."""
    K = d2.shape[-1]
    off = ~torch.eye(K, dtype=torch.bool, device=d2.device)
    masked = torch.where(off, d2.to(F32), 0.0)
    return masked.sum((-2, -1)) / float(max(K * (K - 1), 1)), masked.amax((-2, -1))


def neighbour_d2_summaries(d2s: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The permute engine's local form of :func:`d2_summaries`: mean and
    max per layer over one agent's real neighbours.  ``d2s`` (..., n_nbrs,
    L); ``mask`` (..., n_nbrs) True for a real neighbour (not a phantom
    pair)."""
    m = mask[..., None].to(F32)
    d = d2s.to(F32) * m
    return d.sum(-2) / torch.clamp(m.sum((-2, -1)), min=1.0)[..., None], d.amax(-2)


def _plogp_sum(p: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum p log p`` along ``dim``, 0 where ``p <= 0`` (``xlogy`` rounds
    the log and the product as ``p * log(p)`` does)."""
    p = torch.clamp(p.to(F32), min=0.0)
    return torch.special.xlogy(p, p).sum(dim)


def mixing_entropy(A: torch.Tensor) -> torch.Tensor:
    """Mean column entropy (nats) of mixing matrices ``A (..., L, K, K)``,
    column-stochastic over axis -2."""
    return -_plogp_sum(A, -2).mean((-2, -1))


def column_entropy(w_all: torch.Tensor) -> torch.Tensor:
    """Entropy of one agent's mixing column stacked ``(..., 1 + n_nbrs, L)``
    (the permute engine's local view); its mean over agents is
    :func:`mixing_entropy` of the round's full ``A``."""
    return -_plogp_sum(w_all, -2).mean(-1)


def edge_count(C: torch.Tensor) -> torch.Tensor:
    """Undirected edges of a round's graph from its support ``C (..., K,
    K)`` (self loops on the diagonal)."""
    return ((C > 0.0).to(F32).sum((-2, -1)) - float(C.shape[-1])) / 2.0


def tree_disagreement(tree_K) -> torch.Tensor:
    """``mean_k ||x_k - x_bar||^2`` of an agent-stacked tree, leaf by leaf
    in f32."""
    leaves = tree_leaves(tree_K)
    total = torch.zeros((), dtype=F32, device=leaves[0].device)
    for x in leaves:
        x = x.to(F32)
        total = total + (x - x.mean(0, keepdim=True)).square().sum()
    return total / leaves[0].shape[0]


def tree_mean_sq_norm(tree_K) -> torch.Tensor:
    """Mean per-agent squared norm of an agent-stacked tree (a residual)."""
    leaves = tree_leaves(tree_K)
    total = torch.zeros((), dtype=F32, device=leaves[0].device)
    for x in leaves:
        total = total + x.to(F32).square().sum()
    return total / leaves[0].shape[0]


def suspicion_from_A(A: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Per-agent received-weight deficit of the mixing weights ``A`` (...,
    L, K, K) against the Metropolis weights on the same graph: ``support``
    (..., K, K) is the round's realized support (> 0 on an edge).  (...,
    K): 0 where the network trusts the agent as Metropolis would, towards 1
    where it has stopped listening to it, negative where it trusts it more;
    0 for an isolated agent."""
    K = support.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=A.device)
    adj = ((support > 0.0) & ~eye).to(F32)
    deg = adj.sum(-2) + 1.0
    M0 = adj / torch.maximum(deg[..., :, None], deg[..., None, :])
    recv_m = M0.sum(-1)  # off-diagonal mass each agent receives under Metropolis
    recv_a = (A.to(F32) * (~eye).to(F32)).sum(-1).mean(-2)
    return torch.where(recv_m > 1e-12, (recv_m - recv_a) / torch.clamp(recv_m, min=1e-12), 0.0)


def byzantine_weight_mass(A: torch.Tensor, byz_mask: torch.Tensor) -> torch.Tensor:
    """The share of honest agents' total trust mass (self weight included)
    landing on masked Byzantine sources, averaged over honest receivers and
    layers.  ``A`` (..., L, K, K) column-stochastic; ``byz_mask`` (..., K)
    bool.  The denominator is the whole column: clipping defends by moving
    neighbour mass onto the diagonal, which must lower this number."""
    K = byz_mask.shape[-1]
    eye = torch.eye(K, dtype=F32, device=A.device)
    a = A.to(F32)
    byz = byz_mask.to(F32)
    num = (a * (1.0 - eye) * byz[..., None, :, None]).sum(-2)  # (..., L, K): Byzantine mass into k
    frac = (num / torch.clamp(a.sum(-2), min=1e-12)).mean(-2)
    w = 1.0 - byz  # over honest receivers only
    return (frac * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)


# -- wire bytes, counted from the layout and the realized wire ---------------------


def slab_static_wire_bytes(codec, layout) -> float:
    """Bytes of one agent's encoded slab for a codec whose volume is fixed
    by the shapes (``None`` / identity, the casts, int8), from the layout's
    leaf plans: each leaf's elements at the wire's item size, int8 plus
    one f32 scale per (leaf, slot) segment."""
    leaves = [(g, p) for g in layout.groups for p in g.leaves]
    if codec is None or isinstance(codec, IdentityCodec):
        return float(sum(math.prod(p.shape) * p.dtype.itemsize for _, p in leaves))
    if isinstance(codec, CastCodec):
        return float(sum(math.prod(p.shape) * codec.dtype.itemsize for _, p in leaves))
    if isinstance(codec, Int8StochasticCodec):
        return float(sum(math.prod(p.shape) + 4 * (g.n_slots if p.scale_per_slot else 1) for g, p in leaves))
    raise ValueError(
        f"codec {getattr(codec, 'name', codec)!r} has no static wire volume "
        "(top-k depends on the data: slab_wire_send_bytes counts its wire)"
    )


def slab_identity_bytes(layout) -> float:
    """f32-equivalent bytes of one agent's slab."""
    return slab_static_wire_bytes(None, layout)


def slab_wire_send_bytes(codec, layout, wire) -> torch.Tensor:
    """Bytes of each row's encoded slab: ``wire`` is a ``(rows, D)`` slab
    wire (int8: its ``q`` and ``s``), the result ``(rows,)`` f32.  Fixed by
    the layout except for top-k, whose sent values count 8 bytes each
    (value and index): lane padding is zero and exact zeros are not sent."""
    if isinstance(codec, TopKCodec):
        return 8.0 * (wire != 0).sum(1).to(F32)
    rows = wire.q if isinstance(codec, Int8StochasticCodec) else wire
    return torch.full((rows.shape[0],), slab_static_wire_bytes(codec, layout), dtype=F32, device=rows.device)


def tree_wire_send_bytes(codec, wire, template) -> torch.Tensor:
    """Bytes of a per-leaf wire (the tree paths).  ``wire`` may carry
    leading batch axes beyond the single-agent ``template``'s shapes (the
    gather engine's agents): the result has them.  The codec's static
    volume, except for top-k, whose float leaves count 8 bytes a nonzero.
    The result lies on the wire's device (the template may be meta)."""
    t_leaves = tree_leaves(template)
    w0 = tree_leaves(wire)[0]
    device = getattr(w0, "q", w0).device  # an int8 leaf holds its values in .q
    if not isinstance(codec, TopKCodec):
        resolved = IdentityCodec() if codec is None else codec
        return torch.tensor(float(resolved.wire_bytes(template)), dtype=F32, device=device)
    static, out = 0.0, None
    for w, t in zip(tree_leaves(wire), t_leaves):
        if t.dtype.is_floating_point:
            nb = w.dim() - t.dim()
            nnz = 8.0 * (w != 0).to(F32).sum(tuple(range(nb, w.dim())))
            out = nnz if out is None else out + nnz
        else:
            static += math.prod(t.shape) * t.dtype.itemsize
    if out is None:
        out = torch.zeros((), dtype=F32, device=device)
    return out + static
