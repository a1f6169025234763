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

Not ported yet (they raise ``NotImplementedError``): the tree path,
time-varying schedules on the slab path, momentum, adaptive round budgets,
fault injection, trust reweighting and robust combines.
"""
from __future__ import annotations

from typing import Literal, NamedTuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.codec import (
    CastCodec,
    IdentityCodec,
    Int8StochasticCodec,
    TopKCodec,
    make_codec,
    topk_threshold,
)
from repro_torch.core import drt as drt_mod
from repro_torch.core import packing
from repro_torch.core.drt import DRTConfig, edge_mixing_dense
from repro_torch.core.dynamic import EdgeStacks, csr_from_edges
from repro_torch.kernels.slab_codec import slab_encode_combine, slab_quant_encode
from repro_torch.kernels.slab_combine import slab_combine
from repro_torch.kernels.slab_segment import slab_edge_combine, slab_edge_encode_combine
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
        path=path == "tree",
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
            "runs exact and coded (int8, bf16, f16, topk) round-sets on the slab "
            "and edge paths over a static graph, without control, faults or "
            "robust combines"
        )
