"""Consensus round-sets on the flat slab: the gather engine, exact and coded.

Counterpart of the exact branch and of the coded slab branch (without
faults, control or robust combines) of ``repro.core.consensus``
``gather_consensus_rounds``.

Exact exchange.  The combine is linear, so a whole round-set runs on the
per-layer (L, K, K) Gram matrices:

1. pack the agent-stacked tree once into the (K, D) slab and take the
   per-layer Gram ``G`` (one batched matmul per group);
2. per round, derive the mixing matrices ``A_t`` (DRT eqs. 12-14 from the
   Gram's distances, or the static Metropolis matrix), advance the Gram
   exactly as ``G' = A_t^T G A_t`` and the accumulated product ``M' = M A_t``;
3. apply ``M`` in ONE combine — the ``slab_combine`` kernel on a CUDA slab,
   its plain PyTorch version on a CPU slab — and unpack once.

Two passes over the D parameters in all, whatever the round count.  With
``obs`` the per-round network disagreement is read off the carried Gram.

Coded exchange (``codec`` = ``int8`` | ``bf16`` | ``f16`` | ``topk:<frac>``).
Agents see each other's iterates only through the wire, so every round
works on the slab: pack once, then per round

1. derive the per-agent round keys (``fold_in(fold_in(rng, r), agent)``,
   as the reference's ``_agent_keys``);
2. int8: the scales (plain PyTorch ``slab_quant_scales``, outside the
   kernel as in the reference) and the per-(agent, leaf) key words; top-k:
   the sent slab and the error-feedback residual (``slab_encode_batched``);
3. one ``slab_encode_combine`` call: wire view, per-layer Gram, DRT eqs.
   12-14 (or the Metropolis matrix), off-diagonal combine of the wire view
   plus the full-precision self term;

and unpack once.  :func:`slab_encode_batched` and :func:`slab_decode` put
a whole slab on the wire and back outside a round (top-k's encode is step
2 above; int8 goes through the ``slab_quant_encode`` kernel on a CUDA
slab).  With ``obs`` the per-round disagreement is read off each
round's output slab, so telemetry keeps the fused round (the reference
routes telemetry through its unfused round, which it holds equal to the
fused one).

Sparse edge-list rounds (``path="edge"``, exact or coded): each round's
graph comes from ``edges`` (an :class:`~repro_torch.core.dynamic.EdgeStacks`
with a leading ``rounds`` axis), and every round costs O(|E| D) instead of
the dense O(K^2 D).  Pack once, then per round put the slab on the wire
(exact: the slab itself; int8: ``slab_encode_batched``, one
``slab_quant_encode`` launch on a CUDA slab; bf16/f16: the cast slab;
top-k: the sent slab and the new residual) and

* with ``max_in_degree``: the per-destination CSR tables
  (``dynamic.csr_from_edges``) and ONE ``slab_edge_encode_combine`` call,
  which decodes the compact wire in-kernel;
* without it: ``slab_decode`` and ONE ``slab_edge_combine`` call (the
  scatter combine over the decoded slab);

and unpack once.  ``A`` is the round's edge factors made dense
(``drt.edge_mixing_dense``).  With ``obs`` the disagreement is read off
each round's output slab, so telemetry keeps the kernels (the reference's
telemetry takes its unfused edge round, which it holds equal to the fused
one).

The neighbour-exchange engine (:class:`PermuteConsensus`, slab path):
one agent per rank, each holding only its own single-agent tree,
exchanging whole slabs (or their wires) with one neighbour per exchange
through an explicit exchange (``repro_torch.comm.exchange``:
``ThreadExchange`` or ``DistExchange``, the reference's ``ppermute`` under
``shard_map``).  The graph's edges are decomposed into permutations
(:func:`permutation_decomposition`) or, for any other graph, matchings
(:func:`matching_decomposition`); per round each rank encodes its slab
once, then for each exchange receives one neighbour's wire, decodes it and
takes ``drt_dist`` of every layer slot against its own decoded wire,
computes its local column of A and combines {self} + neighbours in ONE
``slab_source_combine`` call.

The per-leaf tree oracle (:func:`gather_consensus_step`, and
``path="tree"`` of :func:`gather_consensus_rounds`): every round on the
agent-stacked tree, leaf by leaf, in plain PyTorch: each agent's tree goes
through the codec's per-leaf ``encode`` / ``decode``, the distances come
from ``LayerPartition.pairwise_sq_dists`` and the combine is
``LayerPartition.combine`` (neighbours' decoded trees) plus each agent's
full-precision self term.  It is what the slab paths are held against.
A codec without a slab form raises on the slab path (the reference moves
such a run to this oracle quietly; the port does not, so no run asked for
the slab path leaves the kernels unseen).

The kernel parity paths, the reference's per-slot and fused int8 combines:
:func:`combine_slab_per_slot` (one batched ``weighted_combine`` per layer
slot), :func:`dequant_combine_slab_per_slot` (one batched
``dequant_combine`` per slot and leaf) and
:func:`dequant_combine_slab_kernels` (one ``slab_dequant_combine``), each
the partner of a whole-slab combine.

Not ported yet (they raise ``NotImplementedError``): the permute engine's
tree path, time-varying schedules on the slab path, momentum, adaptive
round budgets, fault injection, trust reweighting and robust combines.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Literal, NamedTuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.codec import (
    CastCodec,
    IdentityCodec,
    QuantLeaf,
    Int8StochasticCodec,
    TopKCodec,
    init_comm_state,
    make_codec,
    topk_threshold,
)
from repro_torch.core import drt as drt_mod
from repro_torch.core import packing
from repro_torch.core.drt import DRTConfig, edge_mixing_dense
from repro_torch.core.dynamic import EdgeStacks, csr_from_edges
from repro_torch.core.topology import Topology
from repro_torch.kernels.combine import weighted_combine
from repro_torch.kernels.drt_dist import drt_dist
from repro_torch.kernels.quantize import dequant_combine
from repro_torch.kernels.slab_codec import slab_encode_combine, slab_quant_encode
from repro_torch.kernels.slab_combine import slab_combine, slab_dequant_combine, slab_source_combine
from repro_torch.kernels.slab_segment import slab_edge_combine, slab_edge_encode_combine
from repro_torch.obs.metrics import ConsensusMetrics, ObsConfig, stack_metrics
from repro_torch.utils.pytree import (
    LayerPartition,
    Tree,
    agent_template,
    tree_items,
    tree_leaves,
    tree_map,
)

Algorithm = Literal["drt", "classical"]


def combine_slab_kernels(layout: packing.SlabLayout, M: torch.Tensor, slab: torch.Tensor):
    """Whole-slab combine through ``slab_combine``: the per-block (K, K)
    matrices are gathered from the static ``layout.block_layer`` map."""
    A_blocks = M.float()[layout.block_layer_on(M.device)].contiguous()
    return slab_combine(A_blocks, slab)


def combine_slab_per_slot(layout: packing.SlabLayout, A: torch.Tensor, slab: torch.Tensor):
    """Per-slot combine through ``weighted_combine``, the reference's
    ``_combine_slab_per_slot``: ONE batched launch per DRT layer slot
    (``layout.num_layers`` of them; 11 on ResNet-20), output agent ``k``
    weighted by column ``k`` of the slot's ``A``.  The parity partner of
    :func:`combine_slab_kernels`; returns a new (K, D) slab."""
    A = A.float()
    out = torch.empty_like(slab)
    for p, (s, e) in enumerate(layout.layer_slices):
        out[:, s:e] = weighted_combine(A[p].T.contiguous(), slab[:, s:e])
    return out


def dequant_combine_slab_per_slot(layout: packing.SlabLayout, A_off: torch.Tensor, wire: "SlabQuant"):
    """Per-(slot, leaf) fused int8 dequantize + combine through
    ``dequant_combine``, the reference's ``_dequant_combine_slab_per_slot``:
    ONE batched launch per slot and leaf (:func:`dequant_per_slot_launches`),
    each leaf with its scale segment.  The parity partner of
    :func:`dequant_combine_slab_kernels`; returns a new (K, D) f32 slab
    with zero lane padding."""
    A_off = A_off.float()
    out = torch.zeros(wire.q.shape, dtype=torch.float32, device=wire.q.device)
    for grp in layout.groups:
        for j in range(grp.n_slots):
            W = A_off[grp.layer0 + j].T.contiguous()  # row k: output agent k's weights
            base = grp.col0 + j * grp.s_pad
            for plan in grp.leaves:
                sid = plan.scale_seg0 + (j if plan.scale_per_slot else 0)
                c = slice(base + plan.col0, base + plan.col0 + plan.width)
                out[:, c] = dequant_combine(W, wire.s[:, sid].contiguous(), wire.q[:, c])
    return out


def dequant_combine_slab_kernels(layout: packing.SlabLayout, A_off: torch.Tensor, wire: "SlabQuant"):
    """Fused whole-slab int8 dequantize + combine, the reference's
    ``_dequant_combine_slab_kernels``: ONE ``slab_dequant_combine`` launch,
    the per-block (K, K) matrices gathered from ``layout.block_layer`` and
    each column's scale through the layout's ``col_seg`` map."""
    device = wire.q.device
    A_blocks = A_off.float()[layout.block_layer_on(device)].contiguous()
    return slab_dequant_combine(A_blocks, wire.s.contiguous(), layout.maps_on(device)["col_seg"], wire.q)


def dequant_per_slot_launches(layout: packing.SlabLayout) -> int:
    """``dequant_combine`` launches of :func:`dequant_combine_slab_per_slot`
    on a CUDA slab: one per (slot, leaf)."""
    return sum(g.n_slots * len(g.leaves) for g in layout.groups)


# -- the per-leaf tree oracle ---------------------------------------------------


def gather_consensus_step(
    partition: LayerPartition,
    psi_K: Tree,
    C,
    cfg: DRTConfig,
    algorithm: Algorithm = "drt",
    metropolis=None,
    codec=None,
    codec_state=None,
    rng: "np.ndarray | None" = None,
):
    """One consensus round on the agent-stacked tree, leaf by leaf: the
    reference's ``gather_consensus_step`` (without fault injection and
    trust reweighting).

    Exact exchange: ``A`` from the tree's distances (DRT) or the Metropolis
    matrix (classical), then ``LayerPartition.combine``.  With a codec,
    every agent's tree goes through ``encode`` under its key
    ``fold_in(rng, agent)`` (``rng`` two uint32 words; ``key(0)`` for a
    codec that draws no bits) and ``decode``; ``A`` comes from the decoded
    trees, the neighbours enter the combine decoded and each agent's own
    term at full precision.  Returns ``(new_K, A)``, or ``(new_K, A,
    codec_state)`` when ``codec`` is given (top-k: the new residual tree,
    else the incoming state or ``()``)."""
    legacy_return = codec is None
    wire_codec = None if codec is None else make_codec(codec)
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    L = partition.num_layers
    C = _static_matrix(C, "C", K, device)
    if algorithm == "classical":
        if metropolis is None:
            raise ValueError('algorithm="classical" needs metropolis=')
        metropolis = _static_matrix(metropolis, "metropolis", K, device)
    elif algorithm != "drt":
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def mixing(psi):
        if algorithm == "classical":
            return metropolis.expand(L, K, K)
        d2, n2 = partition.pairwise_sq_dists(psi)
        return drt_mod.drt_mixing_matrices(d2, n2, C, cfg)

    with torch.no_grad():
        if wire_codec is None or isinstance(wire_codec, IdentityCodec):
            A = mixing(psi_K)
            new = partition.combine(A, psi_K)
            if legacy_return:
                return new, A
            return new, A, codec_state if codec_state is not None else ()
        if wire_codec.stateful and codec_state in (None, ()):
            codec_state = init_comm_state(wire_codec, psi_K)
        elif codec_state is None:
            codec_state = ()
        keys = prng.fold_in(_round_set_key(wire_codec, rng), np.arange(K))  # (K, 2)
        wires, states = [], []
        for k in range(K):
            state_k = tree_map(lambda x: x[k], codec_state) if wire_codec.stateful else ()
            wire, state = wire_codec.encode(tree_map(lambda x: x[k], psi_K), state_k, keys[k])
            wires.append(wire)
            states.append(state)
        psi_hat = wire_codec.decode(tree_map(_stack_wire, *wires))
        new_state = tree_map(lambda *xs: torch.stack(xs), *states) if wire_codec.stateful else codec_state
        A = mixing(psi_hat)
        off = partition.combine(A * (1.0 - torch.eye(K, device=device)), psi_hat)
        diag = torch.diagonal(A, dim1=1, dim2=2)  # (L, K) self weights
        selfed = tree_map(
            lambda *xs: torch.stack(xs),
            *[partition.scale_by_layer(diag[:, k], tree_map(lambda x: x[k], psi_K)) for k in range(K)],
        )
        new = tree_map(lambda o, s_: (o.float() + s_.float()).to(s_.dtype), off, selfed)
    if legacy_return:
        return new, A
    return new, A, new_state


def _stack_wire(*leaves):
    """Stack one leaf's per-agent wires along a new agent axis (an int8
    wire stacks its values and its scales)."""
    if isinstance(leaves[0], QuantLeaf):
        return QuantLeaf(q=torch.stack([w.q for w in leaves]), s=torch.stack([w.s for w in leaves]))
    return torch.stack(leaves)


def tree_disagreement(psi_K: Tree) -> torch.Tensor:
    """``mean_k ||x_k - x_bar||^2`` of an agent-stacked tree, summed leaf by
    leaf in f32 (the reference's ``tree_disagreement``)."""
    leaves = tree_leaves(psi_K)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        x = x.float()
        total = total + (x - x.mean(dim=0, keepdim=True)).square().sum()
    return total / leaves[0].shape[0]


def _tree_rounds(partition, psi_K, C, metropolis, cfg, codec, codec_state, rng, *,
                 rounds, algorithm, obs):
    """``path="tree"`` of :func:`gather_consensus_rounds`: ``rounds`` calls
    of :func:`gather_consensus_step`, round ``r`` keyed ``fold_in(rng, r)``
    and the codec state (top-k's residual) threaded through."""
    state = codec_state  # gather_consensus_step starts top-k from zero
    per_round = []
    for r in range(rounds):
        if codec is None:
            psi_K, A = gather_consensus_step(partition, psi_K, C, cfg, algorithm, metropolis)
        else:
            round_rng = None if rng is None else prng.fold_in(rng, r)
            psi_K, A, state = gather_consensus_step(
                partition, psi_K, C, cfg, algorithm, metropolis,
                codec=codec, codec_state=state, rng=round_rng,
            )
        if obs is not None:
            per_round.append(ConsensusMetrics(
                disagreement=tree_disagreement(psi_K),
                effective_rounds=torch.tensor(float(r + 1), device=A.device),
            ))
    out = (psi_K, A)
    if codec is not None:
        out += (state,)
    if obs is not None:
        out += (stack_metrics(per_round),)
    return out


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
    codec_state=None,
    rng: "np.ndarray | None" = None,
    path: str = "slab",
    edges: "EdgeStacks | None" = None,
    max_in_degree: "int | None" = None,
    momentum: float = 0.0,
    round_tol: float | None = None,
    faults=None,
    trust_clip: float | None = None,
    trust_temp: float | None = None,
    combine: str = "drt",
):
    """``rounds`` consensus rounds with one pack and one unpack.

    ``psi_K``: agent-stacked tree (leading K on every leaf).  ``C``: the
    (K, K) support matrix; ``metropolis``: the (K, K) classical mixing
    matrix (needed for ``algorithm="classical"``).  Returns ``(new_K,
    A_last)``, or ``(new_K, A_last, metrics)`` with ``obs`` (a
    :class:`~repro_torch.obs.metrics.ConsensusMetrics` with a leading
    ``(rounds,)`` axis).  Runs under ``torch.no_grad``: consensus sits
    outside the gradient.

    With a ``codec`` (a name or a ``repro_torch.comm.codec`` instance; the
    identity codec runs the exact path) the return carries the new codec
    state after ``A_last``, as the reference's does: the top-k residual
    tree (f32, shaped like ``psi_K``), else ``()``.  ``codec_state`` is the
    incoming one (``None`` or ``()`` starts top-k from zero).  ``rng`` is
    the round-set's key, two uint32 words (``repro_torch.comm.prng``); the
    int8 codec needs one, the others default to ``key(0)``.

    ``path="edge"`` runs the sparse rounds over ``edges`` (module
    docstring); ``max_in_degree`` (a host bound on any agent's in-degree,
    ``dynamic.max_in_degree_from_topology``) selects the CSR combine.  ``C``
    and ``metropolis`` are then only shape-checked, ``(K, K)`` or
    ``(rounds, K, K)``: the edge list carries the graph.

    ``path="tree"`` runs the per-leaf oracle: ``rounds`` calls of
    :func:`gather_consensus_step` on the tree (no slab), round ``r`` keyed
    ``fold_in(rng, r)``, top-k's residual threaded through; with ``obs``
    the disagreement is read off each round's tree.
    """
    wire_codec = None if codec is None else make_codec(codec)
    if path not in ("slab", "edge", "tree"):
        raise ValueError(f"unknown consensus path {path!r}")
    if path == "edge" and edges is None:
        raise ValueError(
            'path="edge" needs edges= (an EdgeStacks round stack, e.g. '
            "dynamic.edge_stacks_from_topology)"
        )
    _refuse_unported(
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
    if path == "tree":
        return _tree_rounds(
            partition, psi_K, C, metropolis, cfg, wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs,
        )
    if layout is None:
        layout = packing.build_slab_layout(partition, agent_template(psi_K))
    if path == "edge":
        _check_mix_shape(C, "C", K, rounds)
        if metropolis is not None:
            _check_mix_shape(metropolis, "metropolis", K, rounds)
        return _edge_rounds(
            layout, psi_K, edges, max_in_degree, cfg, wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs,
        )
    C = _static_matrix(C, "C", K, device)
    if algorithm == "classical":
        if metropolis is None:
            raise ValueError('algorithm="classical" needs metropolis=')
        metropolis = _static_matrix(metropolis, "metropolis", K, device)
    if wire_codec is not None and not isinstance(wire_codec, IdentityCodec):
        return _coded_rounds(
            layout, psi_K, C, metropolis, cfg, wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs,
        )

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
    out = (new_K, A)
    if wire_codec is not None:  # the identity codec: its state passes through
        out += (codec_state if codec_state is not None else (),)
    if obs is not None:
        out += (stack_metrics(per_round),)
    return out


def _wire_mode(codec) -> str:
    """The ``slab_encode_combine`` mode of a codec."""
    if isinstance(codec, Int8StochasticCodec):
        return "int8"
    if isinstance(codec, TopKCodec):
        return "sent"
    if isinstance(codec, CastCodec) and codec.dtype in (torch.bfloat16, torch.float16):
        return "bf16" if codec.dtype == torch.bfloat16 else "f16"
    raise NotImplementedError(f"codec {codec!r} has no slab path in the port")


def _coded_rounds(layout, psi_K, C, metropolis, cfg, codec, codec_state, rng, *,
                  rounds, algorithm, obs):
    """The coded branch of :func:`gather_consensus_rounds` (see the module
    docstring): one ``slab_encode_combine`` call per round."""
    mode = _wire_mode(codec)
    rng = _round_set_key(codec, rng)
    K = C.shape[0]
    device = C.device
    mix = C if algorithm == "drt" else metropolis
    kw = dict(mode=mode, algorithm=algorithm, num_layers=layout.num_layers,
              kappa=cfg.kappa, N_clip=cfg.resolve_N(K), weight_mode=cfg.weight_mode)
    if mode == "int8":
        kw["qmax"] = codec.qmax
    bl = layout.maps_on(device)["block_layer"]
    with torch.no_grad():
        slab = layout.pack(psi_K)
        res = _packed_residual(codec, codec_state, layout, K, device)
        per_round = []
        for r in range(rounds):
            keys = prng.fold_in(prng.fold_in(rng, r), np.arange(K))  # (K, 2) agent keys
            if mode == "int8":
                wire = packing.int8_wire_operands(codec, layout, slab, keys)
            elif mode == "sent":
                sent, res = slab_encode_batched(codec, layout, slab, res, keys)
                wire = (sent,)
            else:
                wire = ()
            slab, A = slab_encode_combine(bl, slab, wire, mix, **kw)
            if obs is not None:
                per_round.append(_slab_metrics(slab, layout, r))
        new_K = layout.unpack(slab, like=psi_K)
        state = layout.unpack(res, like=psi_K, dtype=torch.float32) if codec.stateful else ()
    if obs is None:
        return new_K, A, state
    return new_K, A, state, stack_metrics(per_round)


def _edge_rounds(layout, psi_K, edges, max_in_degree, cfg, codec, codec_state, rng, *,
                 rounds, algorithm, obs):
    """The edge branch of :func:`gather_consensus_rounds` (module
    docstring): one ``slab_edge_encode_combine`` (or, without
    ``max_in_degree``, ``slab_edge_combine``) call per round."""
    exact = codec is None or isinstance(codec, IdentityCodec)
    mode = "exact" if exact else _wire_mode(codec)
    if edges.src.dim() != 2 or edges.src.shape[0] != rounds:
        raise ValueError(
            f"edges must stack (rounds={rounds}, E) lists, got src {tuple(edges.src.shape)}"
        )
    if not exact:
        rng = _round_set_key(codec, rng)
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    maps = layout.maps_on(device)
    bl = maps["block_layer"]
    src_r, dst_r = (torch.as_tensor(t, device=device).to(torch.int32) for t in edges[:2])
    w_r = torch.as_tensor(edges.w, device=device).to(torch.float32)
    kw = dict(algorithm=algorithm, num_layers=layout.num_layers, kappa=cfg.kappa,
              N_clip=cfg.resolve_N(K), weight_mode=cfg.weight_mode)
    with torch.no_grad():
        slab = layout.pack(psi_K)
        res = None if exact else _packed_residual(codec, codec_state, layout, K, device)
        per_round = []
        for r in range(rounds):
            src, dst, w = src_r[r].contiguous(), dst_r[r].contiguous(), w_r[r].contiguous()
            if exact:
                wire, ops = slab, (slab,)
            else:
                keys = prng.fold_in(prng.fold_in(rng, r), np.arange(K))  # (K, 2) agent keys
                wire, res = slab_encode_batched(codec, layout, slab, res, keys)
                ops = (wire.q, wire.s, maps["col_seg"]) if mode == "int8" else (wire,)
            if max_in_degree is not None:
                nbr, pos, valid, _ = csr_from_edges(src, dst, w, K, max_in_degree)
                slab, A_self, A_e = slab_edge_encode_combine(
                    bl, slab, ops, src, dst, w, nbr, pos, valid, mode=mode, **kw
                )
            else:
                dec = slab if exact else slab_decode(codec, layout, wire)
                slab, A_self, A_e = slab_edge_combine(bl, slab, dec, src, dst, w, **kw)
            A = edge_mixing_dense(A_self, A_e, src, dst, w, K)
            if obs is not None:
                per_round.append(_slab_metrics(slab, layout, r))
        new_K = layout.unpack(slab, like=psi_K)
    out = (new_K, A)
    if res is not None:
        out += (layout.unpack(res, like=psi_K, dtype=torch.float32),)
    elif codec is not None:
        out += (codec_state if codec_state is not None else (),)
    if obs is not None:
        out += (stack_metrics(per_round),)
    return out


def _round_set_key(codec, rng):
    """The coded round-set's key: ``rng``, or ``key(0)`` for a codec that
    draws no random bits."""
    if rng is None:
        if codec.needs_rng:
            raise ValueError(
                f"codec {codec.name!r} is stochastic; pass rng= (a fresh key per round-set)"
            )
        return prng.key(0)
    return rng


def _packed_residual(codec, codec_state, layout, K: int, device):
    """The incoming error-feedback residual as a slab (zero to start) for a
    stateful codec (top-k), else ``None``."""
    if not codec.stateful:
        return None
    if codec_state not in (None, ()):
        return layout.pack(codec_state)
    return packing.slab_init_state(codec, layout, K, device)


def _slab_metrics(slab, layout, r: int) -> ConsensusMetrics:
    """Round ``r``'s telemetry, read off its output slab."""
    return ConsensusMetrics(
        disagreement=packing.slab_disagreement(slab, layout),
        effective_rounds=torch.tensor(float(r + 1), device=slab.device),
    )


class SlabQuant(NamedTuple):
    """The int8 wire of a (K, D) slab: values and per-segment scales."""

    q: torch.Tensor  # (K, D) int8
    s: torch.Tensor  # (K, n_scale_segs) f32


def slab_encode_batched(codec, layout: packing.SlabLayout, slab: torch.Tensor, state, keys_K):
    """Encode every agent's (K, D) slab.  Returns ``(wire, new_state)``,
    bit-identical to the reference's ``slab_encode_batched``:

    * identity -- the slab; bf16/f16 -- the cast slab;
    * int8 -- :class:`SlabQuant` through ``slab_quant_encode`` (the kernel
      on a CUDA slab, its plain version on a CPU slab); ``keys_K`` are the
      (K, 2) per-agent round keys;
    * top-k -- ``(sent, residual)`` slabs: per leaf and agent, ``y = x +
      residual``, the threshold from the reference's sampled elements, ties
      sent, ``residual' = y - sent``."""
    if codec is None or isinstance(codec, IdentityCodec):
        return slab, state
    if isinstance(codec, CastCodec):
        return slab.to(codec.dtype), state
    if isinstance(codec, Int8StochasticCodec):
        if keys_K is None:
            raise ValueError("int8 codec needs rng keys (stochastic rounding)")
        ops = packing.int8_wire_operands(codec, layout, slab, keys_K)
        return SlabQuant(q=slab_quant_encode(*ops, slab, qmax=codec.qmax), s=ops[0]), state
    if isinstance(codec, TopKCodec):
        if not torch.is_tensor(state):
            state = packing.slab_init_state(codec, layout, slab.shape[0], slab.device)
        y = slab.float() + state
        ay = y.abs()
        sent = torch.zeros_like(y)
        for grp, plan, k, slots, cols in layout.topk_plan(codec.frac, codec.sample, slab.device):
            a = layout.group_view(ay, grp)
            thresh = topk_threshold(a[:, slots, cols], k)  # (K,)
            c = slice(plan.col0, plan.col0 + plan.width)
            piece = a[:, :, c]
            mask = (piece >= thresh[:, None, None]) & (piece > 0.0)
            layout.group_view(sent, grp)[:, :, c] = torch.where(
                mask, layout.group_view(y, grp)[:, :, c], 0.0
            )
        return sent, y - sent
    raise NotImplementedError(f"no slab path for codec {codec!r}")


def slab_decode(codec, layout: packing.SlabLayout, wire) -> torch.Tensor:
    """The f32 (K, D) reconstruction of an encoded wire."""
    if codec is None or isinstance(codec, (IdentityCodec, TopKCodec)):
        return wire
    if isinstance(codec, CastCodec):
        return wire.float()
    if isinstance(codec, Int8StochasticCodec):
        seg = layout.maps_on(wire.q.device)["col_seg"].long()
        return wire.q.float() * wire.s[:, seg]
    raise NotImplementedError(f"no slab path for codec {codec!r}")


def _static_matrix(mat, name: str, K: int, device) -> torch.Tensor:
    t = torch.as_tensor(mat, dtype=torch.float32, device=device).contiguous()
    if t.dim() == 3:
        raise NotImplementedError(
            f"per-round {name} stacks (time-varying schedules) are not ported yet"
        )
    if tuple(t.shape) != (K, K):
        raise ValueError(f"{name} must be ({K}, {K}), got {tuple(t.shape)}")
    return t


def _check_mix_shape(mat, name: str, K: int, rounds: int) -> None:
    shape = tuple(np.shape(mat))
    if shape not in ((K, K), (rounds, K, K)):
        raise ValueError(f"{name} must be ({K}, {K}) or ({rounds}, {K}, {K}), got {shape}")


def _refuse_unported(**flags: bool) -> None:
    on = sorted(name for name, set_ in flags.items() if set_)
    if on:
        raise NotImplementedError(
            f"gather_consensus_rounds: {', '.join(on)} not ported yet; the port "
            "runs exact and coded (int8, bf16, f16, topk) round-sets on the slab, "
            "edge and tree paths over a static graph, without control, faults or "
            "robust combines"
        )


# -- the neighbour-exchange engine -------------------------------------------------


def permutation_decomposition(topology: Topology) -> "list[np.ndarray] | None":
    """Decompose the neighbour exchange into agent permutations ``perm``
    (``perm[src] = dst``), one per exchange; ``None`` when no structured
    decomposition is known (the engine then takes
    :func:`matching_decomposition`).  The reference's, bit for bit."""
    K = topology.num_agents
    name = topology.name
    if name == "ring":
        plus = (np.arange(K) + 1) % K  # agent j sends to (j + 1) % K
        minus = (np.arange(K) - 1) % K
        return [plus] if K == 2 else [plus, minus]
    if name == "hypercube":
        d = int(np.log2(K))
        return [np.arange(K) ^ (1 << b) for b in range(d)]
    if name == "torus2d":
        s = int(round(np.sqrt(K)))
        idx = np.arange(K)
        r, c = idx // s, idx % s
        perms = [((r + 1) % s) * s + c, ((r - 1) % s) * s + c, r * s + (c + 1) % s, r * s + (c - 1) % s]
        out, seen = [], set()
        for p in perms:  # s == 2 makes +1 and -1 the same permutation
            key = tuple(p.tolist())
            if key not in seen:
                seen.add(key)
                out.append(p)
        return out
    if name == "full":
        return [np.roll(np.arange(K), -s) for s in range(1, K)]
    return None  # chain (endpoints), erdos_renyi, star, anything else


def matching_decomposition(topology: Topology) -> list[np.ndarray]:
    """Any graph's edges as matchings, by greedy proper edge colouring (at
    most ``2 * max_degree - 1`` of them), each an involutive permutation in
    which an unmatched agent maps to itself (a phantom pair, masked out of
    the mixing weights).  Every undirected edge lands in exactly one
    matching.  The reference's, bit for bit."""
    K = topology.num_agents
    A = topology.adjacency
    classes: list[list[tuple[int, int]]] = []
    used: list[np.ndarray] = []  # per class: endpoint already matched?
    for i in range(K):
        for j in range(i + 1, K):
            if not A[i, j]:
                continue
            for c in range(len(classes)):
                if not used[c][i] and not used[c][j]:
                    classes[c].append((i, j))
                    used[c][i] = used[c][j] = True
                    break
            else:
                classes.append([(i, j)])
                u = np.zeros(K, dtype=bool)
                u[i] = u[j] = True
                used.append(u)
    perms = []
    for cls in classes:
        p = np.arange(K)
        for i, j in cls:
            p[i], p[j] = j, i
        perms.append(p)
    return perms


def exchange_decomposition(topology: Topology) -> list[np.ndarray]:
    """The permutations the permute engine exchanges over: the structured
    decomposition where one is known, else the matchings."""
    decomp = permutation_decomposition(topology)
    return matching_decomposition(topology) if decomp is None else decomp


class _RankColumn(NamedTuple):
    """One agent's static mixing-column pieces (``PermuteConsensus``)."""

    fixed: "torch.Tensor | None"  # classical: the (1 + n, L) Metropolis column
    mask: "torch.Tensor | None"  # DRT: (n,) real neighbour (not a phantom pair)
    log_cw: "torch.Tensor | None"  # DRT: (n,) log of the edge weight (0 on phantoms)
    log_ckk: "float | None"  # DRT: log(c_kk / n_eff); None for an isolated agent


class _RoundCtx(NamedTuple):
    """A static topology's exchange structure, built once per engine."""

    perms: list  # per exchange: the (src, dst) pair list for ppermute
    inv_srcs: list  # per exchange: (K,) source agent of each receiver (itself on a phantom pair)
    C: np.ndarray  # (K, K) f32 support matrix
    metropolis: np.ndarray  # (K, K) f32 classical mixing matrix


@dataclasses.dataclass(frozen=True)
class PermuteConsensus:
    """Neighbour-exchange consensus engine, one agent per rank (module
    docstring), on the slab path.

    Each rank calls ``engine(psi_local, exchange, codec_state, rng,
    rounds=...)`` with its own single-agent tree (no agent axis) and its
    exchange (``repro_torch.comm.exchange``; ``rank`` is the agent).
    Tensors stay on the device they arrive on: CPU tensors take the
    kernels' plain versions, CUDA tensors launch the kernels or raise.

    A round-set of R rounds makes, per rank, ``R x n_exchanges x L``
    ``drt_dist`` calls (none for classical; a phantom pair costs its calls
    too), R ``slab_source_combine`` launches and, for int8, R
    ``slab_quant_encode`` launches (the rank's wire).

    Not ported (``NotImplementedError``): ``path="tree"``, ``schedule``,
    ``momentum``, ``round_tol``, ``trust_clip`` / ``trust_temp``, a
    non-empty ``norm_reduce_axes`` and ``obs``.
    """

    partition: LayerPartition
    topology: Topology
    cfg: DRTConfig
    algorithm: Algorithm = "drt"
    codec: object = None
    path: str = "slab"
    norm_reduce_axes: tuple = ()
    schedule: object = None
    momentum: float = 0.0
    round_tol: float | None = None
    trust_clip: float | None = None
    trust_temp: float | None = None
    _cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)
    _lock: object = dataclasses.field(default_factory=threading.Lock, init=False, repr=False,
                                      compare=False)

    def _round_ctx(self) -> _RoundCtx:
        """The static topology's perms, receivers' sources and matrices
        (built once, shared by every rank)."""
        with self._lock:
            ctx = self._cache.get("ctx")
            if ctx is None:
                decomp = exchange_decomposition(self.topology)
                perms = [[(int(s), int(p[s])) for s in range(len(p))] for p in decomp]
                inv_srcs = []
                for p in decomp:
                    inv = np.empty(len(p), np.int64)
                    inv[p] = np.arange(len(p))
                    inv_srcs.append(inv)
                ctx = self._cache["ctx"] = _RoundCtx(
                    perms, inv_srcs, self.topology.c_matrix().astype(np.float32),
                    self.topology.metropolis().astype(np.float32),
                )
        return ctx

    def _layout(self, psi_local: Tree) -> packing.SlabLayout:
        """The slab layout of a single-agent tree (built once per leaf
        shapes and dtypes, shared by every rank)."""
        key = tuple((path, tuple(x.shape), x.dtype) for path, x in tree_items(psi_local))
        with self._lock:
            layout = self._cache.get(key)
            if layout is None:
                layout = self._cache[key] = packing.build_slab_layout(self.partition, psi_local)
        return layout

    def _rank_column(self, ctx: _RoundCtx, my: int, L: int, dev) -> "_RankColumn":
        """The static part of agent ``my``'s mixing column, on ``dev``
        once per call (the graph does not change between rounds)."""
        srcs = np.array([inv[my] for inv in ctx.inv_srcs], np.int64)
        cw = np.where(srcs != my, ctx.C[srcs, my], np.float32(0.0)).astype(np.float32)
        mask = cw > 0  # cw = 0: a phantom pair (the agent received itself)
        n_eff = int(mask.sum())  # the surviving neighbourhood
        if self.algorithm == "classical":
            w_nbrs = np.where(mask, ctx.metropolis[srcs, my], np.float32(0.0)).astype(np.float32)
            w = np.concatenate([[ctx.metropolis[my, my]], w_nbrs]).astype(np.float32)
            return _RankColumn(torch.from_numpy(np.repeat(w[:, None], L, axis=1)).to(dev), None, None, None)
        log_cw = np.log(np.where(mask, cw, np.float32(1.0)))
        # the self term log(c_kk / n_eff), f32 as the reference rounds it
        log_ckk = float(np.log(ctx.C[my, my] / np.float32(max(n_eff, 1))))
        return _RankColumn(None, torch.from_numpy(mask).to(dev), torch.from_numpy(log_cw).to(dev),
                           log_ckk if n_eff > 0 else None)

    def _mix_weights(self, col: "_RankColumn", d2, n2):
        """The local column of A, ``(1 + n_exchanges, L)`` f32 (self first),
        from the exchanges' stats ``d2`` / ``n2`` (n_exchanges, L); every
        constant rounded to f32 as the reference computes it."""
        if col.fixed is not None:  # classical: the Metropolis column
            return col.fixed
        L = d2.shape[1]
        kappa = self.cfg.kappa
        log_n, log2_l1 = drt_mod.edge_log_constants(L, self.cfg.resolve_N(self.topology.num_agents))
        log_prod = torch.log1p(d2 / (n2 + kappa)).sum(1, keepdim=True) + log2_l1
        if self.cfg.weight_mode == "paper":
            log_denom = torch.log(d2 + kappa)
        elif self.cfg.weight_mode == "exact_grad":
            log_denom = torch.log(n2 + kappa + d2)
        else:
            raise ValueError(f"unknown weight_mode {self.cfg.weight_mode!r}")
        neg = drt_mod._NEG_INF
        mask = col.mask[:, None]
        log_a = torch.where(mask, log_prod - log_denom + col.log_cw[:, None], neg)
        # the clip's smallest entry per layer: over real neighbours only
        log_a = torch.minimum(log_a, log_n + torch.where(mask, log_a, -neg).amin(0))
        if col.log_ckk is None:  # an isolated agent: self weight 1, everything else masked
            log_self = torch.zeros(L, dtype=torch.float32, device=d2.device)
        else:
            log_self = col.log_ckk + torch.logsumexp(log_a, 0)
        log_all = torch.cat([log_self[None], log_a])
        ex = torch.exp(log_all - log_all.amax(0, keepdim=True))
        return ex / ex.sum(0, keepdim=True)

    def __call__(self, psi_local: Tree, exchange, codec_state=None, rng=None, *, rounds: int = 1,
                 obs=None):
        """Run ``rounds`` consensus rounds for ``exchange.rank``'s agent.

        ``psi_local``: the agent's single-agent tree (no leading agent
        axis).  ``rng``: the round-set's key, two uint32 words
        (``repro_torch.comm.prng``), the same on every rank; round ``r``'s
        wire key is ``fold_in(fold_in(rng, r), rank)``.  Returns the
        combined tree, or ``(tree, codec_state)`` when the engine has a
        codec (top-k: the f32 residual tree; else ``codec_state`` or
        ``()``)."""
        unported = {
            'path="tree"': self.path == "tree",
            "schedule": self.schedule is not None,
            "momentum": float(self.momentum) != 0.0,
            "round_tol": self.round_tol is not None,
            "trust_clip/trust_temp": self.trust_clip is not None or self.trust_temp is not None,
            "norm_reduce_axes": bool(self.norm_reduce_axes),
            "obs": obs is not None,
        }
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"PermuteConsensus: {', '.join(on)} not ported yet (ROADMAP.md Queue 1); the "
                "port runs exact and coded round-sets on the slab path over a static graph"
            )
        if self.path != "slab":
            raise ValueError(f"unknown consensus path {self.path!r}")
        if self.algorithm not in ("drt", "classical"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if rounds < 1:
            raise ValueError(
                f"PermuteConsensus needs rounds >= 1, got {rounds}; skip the call entirely "
                "for a consensus-free step"
            )
        K = self.topology.num_agents
        if exchange.size != K:
            raise ValueError(f"exchange has {exchange.size} ranks, the topology {K} agents")
        codec = None if self.codec is None else make_codec(self.codec)
        wire_codec = None if isinstance(codec, IdentityCodec) else codec
        if wire_codec is not None:
            _wire_mode(wire_codec)  # refuses codecs without a slab path
            rng = _round_set_key(wire_codec, rng)
        with torch.no_grad():
            out, res = self._call_slab(psi_local, exchange, codec_state, rng, rounds, wire_codec)
        if codec is None:
            return out
        if res is not None:
            return out, res
        return out, codec_state if codec_state is not None else ()

    def _call_slab(self, psi_local, exchange, codec_state, rng, rounds, wire_codec):
        """The slab round loop of one rank (module docstring).  Returns
        ``(tree, residual tree or None)``."""
        my = exchange.rank
        ctx = self._round_ctx()
        layout = self._layout(psi_local)
        one = tree_map(lambda x: x[None], psi_local)  # the (1, ...) agent-stacked form
        slab = layout.pack(one)  # (1, D)
        device = slab.device
        stateful = wire_codec is not None and wire_codec.stateful
        res = None
        if stateful:
            if codec_state in (None, ()):
                res = packing.slab_init_state(wire_codec, layout, 1, device)
            else:
                res = layout.pack(tree_map(lambda x: x[None], codec_state))
        bl = layout.block_layer_on(device)
        col = self._rank_column(ctx, my, layout.num_layers, device)
        for r in range(rounds):
            if wire_codec is not None:
                key = prng.fold_in(prng.fold_in(rng, r), my)
                wire, res = slab_encode_batched(wire_codec, layout, slab, res, key[None])
                self_hat = slab_decode(wire_codec, layout, wire)
            else:
                wire = self_hat = slab
            if not ctx.perms:
                continue  # no edge anywhere: every iterate stays as it is
            quant = isinstance(wire, SlabQuant)
            recvs, d2s, n2s = [], [], []
            for perm in ctx.perms:
                got = exchange.ppermute(tuple(wire) if quant else (wire,), perm)
                recv = slab_decode(wire_codec, layout, SlabQuant(*got) if quant else got[0])
                if self.algorithm == "drt":
                    st = torch.stack([drt_dist(self_hat[0, s:e], recv[0, s:e])
                                      for s, e in layout.layer_slices])  # (L, 2)
                    d2s.append(st[:, 0])
                    n2s.append(st[:, 1])
                recvs.append(recv[0])
            stats = (torch.stack(d2s), torch.stack(n2s)) if d2s else (None, None)
            w_all = self._mix_weights(col, *stats)  # (1 + n, L)
            w_blocks = w_all.index_select(1, bl).T.contiguous()  # (n_blocks, 1 + n)
            # the combine takes the agent's full-precision slab, not its wire
            slab = slab_source_combine(w_blocks, torch.stack([slab[0]] + recvs))[None]
        out = tree_map(lambda x: x[0], layout.unpack(slab, like=one))
        if res is None:
            return out, None
        like = one if codec_state in (None, ()) else tree_map(lambda x: x[None], codec_state)
        return out, tree_map(lambda x: x[0], layout.unpack(res, like=like, dtype=torch.float32))

