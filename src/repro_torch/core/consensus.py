"""Consensus round-sets on the flat slab: the gather engine, exact and coded.

Counterpart of ``gather_consensus_rounds`` and ``PermuteConsensus`` of
``repro.core.consensus``.

Exact exchange.  The combine is linear, so a whole round-set runs on the
per-layer (L, K, K) Gram matrices:

1. pack the agent-stacked tree once into the (K, D) slab and take the
   per-layer Gram ``G`` (one batched matmul per group);
2. per round, derive the mixing matrices ``A_t`` (DRT eqs. 12-14 from the
   Gram's distances, or the round's Metropolis matrix), advance the Gram
   exactly as ``G' = A_t^T G A_t`` and the accumulated product ``M' = M A_t``;
3. apply ``M`` in ONE combine -- the ``slab_combine`` kernel on a CUDA slab,
   its plain PyTorch version on a CPU slab -- and unpack once.

Two passes over the D parameters in all, whatever the round count.  With
``obs`` each round's disagreement and distances are read off the carried
Gram.

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
round's output slab and the distances off the Gram the call returns, so
telemetry keeps the fused round (the reference routes telemetry through
its unfused round, which it holds equal to the fused one).

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
each round's output slab and the distances are the call's per-edge
``d2e``, so telemetry keeps the kernels (the reference's telemetry takes
its unfused edge round, which it holds equal to the fused one).

Dynamic graphs and round control, on every path of both engines.  ``C``
and ``metropolis`` may be per-round ``(rounds, K, K)`` stacks
(``TopologySchedule.mixing_stacks``): round ``r`` mixes over slice ``r``,
the Gram recurrence included.  ``momentum=beta`` adds the heavy-ball term
``x' = mix(x) + beta (x - x_prev)`` to each round's output (on the exact
Gram path in coefficient space: ``M' = M A + beta (M - M_prev)``, ``M_0 =
M_{-1} = I``, every statistic ``gram_update(G0, M)`` off the initial Gram,
still one combine).  ``round_tol=tol`` makes the budget adaptive: before
each round the carried disagreement is compared with ``tol``, and once it
is at or below it the round and every later one keep the iterate, the
residual, ``A`` and ``x_prev`` as they are (:class:`_Control`: a 0-d bool
tensor on the device through ``torch.where``, no host sync).  The kernels
still launch on every round, as the reference computes every round of its
scan; telemetry's ``effective_rounds`` counts the rounds that ran.

The neighbour-exchange engine (:class:`PermuteConsensus`, slab path):
one agent per rank, each holding only its own single-agent tree,
exchanging whole slabs (or their wires) with one neighbour per exchange
through an explicit exchange (``repro_torch.comm.exchange``:
``ThreadExchange`` or ``DistExchange``, the reference's ``ppermute`` under
``shard_map``).  The graph's edges are decomposed into permutations
(:func:`permutation_decomposition`) or, for any other graph, matchings
(:func:`matching_decomposition`); per round each rank encodes its slab
once, then for each exchange receives one neighbour's wire, decodes it and
takes ``drt_dist`` of every layer slot against its own decoded wire (one
``drt_dist_slots`` call over all slots), computes its local column of A
and combines {self} + neighbours in ONE ``slab_source_combine`` call,
which reads its own slab and each received one where it lies (no stack).
With a ``schedule`` each round exchanges over its realized graph; its
adaptive gate reads the global disagreement through ``exchange.psum``.
Its ``path="tree"`` runs the same rounds leaf by leaf in plain PyTorch (no
kernel): the codec's per-leaf ``encode`` / ``decode``, every leaf of the
wire in one ``ppermute`` per exchange, per-layer norms from
``LayerPartition.sq_norms`` and the combine through
``LayerPartition.scale_by_layer``.

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
:func:`combine_slab_per_slot` (one ``weighted_combine`` launch over every
layer slot, each with its matrix), :func:`dequant_combine_slab_per_slot`
(one ``dequant_combine`` launch over every slot and leaf) and
:func:`dequant_combine_slab_kernels` (one ``slab_dequant_combine``), each
the partner of a whole-slab combine.

Faults and robust combines (:mod:`repro_torch.faults`).  A round-set's
``faults`` make its masked agents publish a faulted view of their iterate
(the attack applies before the encode, so the poison goes through the codec
and the DRT statistics as honest traffic does) while each agent's self term
keeps its true iterate; stale senders re-publish their previous-round
iterate first.  Exact round-sets then leave the Gram recurrence (a
nonlinear publish has no coefficient form) for the per-round slab body of
the reference's non-fused round, as do coded round-sets under faults or a
trust knob and any round-set with a robust combine: publish, encode (int8:
ONE ``slab_quant_encode`` launch), decode, the decoded slab's Gram (plain
``torch``), the mixing and its reweighting, then ONE ``slab_combine`` of
the decoded published slab over ``A``'s off-diagonal plus an elementwise
self term; a trimmed-mean or median combine runs no kernel (``torch.sort``),
as in the reference.  Trust reweighting alone on an exact round-set stays
on the Gram recurrence (it is linear: reweight ``A``, then ``M' = M A``,
one ``slab_combine`` at the end).  The tree path takes attacks (not stale
delivery) through ``gather_consensus_step(publish=...)``.  The edge path
takes attacks, stale delivery and the trust knobs through its kernels: the
published slab is the wire and the true slab the self term, and
``reweight_edge`` runs between a call's factors launch and its combine
launch.  Message drop is a schedule (``faults.DropSchedule``) and runs on
every path.  ``PermuteConsensus`` takes the trust knobs on its slab and
tree paths, on each rank's local column; fault injection stays on the
gather engine, as in the reference.

Telemetry (``obs``; :mod:`repro_torch.obs.metrics`) on every path of both
engines: each round's full ``ConsensusMetrics`` record, from what the round
already holds, with no extra launch of a consensus kernel on the gather
engine; ``ObsConfig(annotate=True)`` names the slab phases
(``consensus.pack``, ``.encode``, ``.decode``, ``.combine``, ``.unpack``)
for a profiler trace.
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.faults import models as fault_models
from repro_torch.faults import robust
from repro_torch.kernels.combine import weighted_combine_segments
from repro_torch.kernels.drt_dist import drt_dist_slots
from repro_torch.kernels.quantize import dequant_combine_segments
from repro_torch.kernels.slab_codec import slab_encode_combine, slab_quant_encode
from repro_torch.kernels.slab_combine import slab_combine, slab_dequant_combine, slab_source_combine
from repro_torch.kernels.slab_segment import slab_edge_combine, slab_edge_encode_combine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import ConsensusMetrics, ObsConfig
from repro_torch.obs.profiling import scope
from repro_torch.utils.pytree import (
    LayerPartition,
    as_f32,
    Tree,
    agent_template,
    tree_items,
    tree_leaves,
    tree_like,
    tree_map,
)

Algorithm = Literal["drt", "classical"]


class _Control:
    """Consensus control of one round-set, the reference's scan-carry
    extras.  ``beta``: heavy-ball momentum on each round's output, ``x' =
    mix(x) + beta (x - x_prev)`` with ``x_prev`` starting at ``x0``.
    ``tol``: the adaptive gate, sticky, checked before each round on the
    carried disagreement; a round gated off keeps what :meth:`keep` is
    given.  The gate is a 0-d bool tensor on the device: no host sync.
    Works on tensors and trees alike."""

    def __init__(self, beta: float, tol: "float | None", x0, device, track: bool = False):
        self.beta, self.tol = beta, tol
        self.on = beta != 0.0 or tol is not None
        self.prev = x0 if beta != 0.0 else None
        self.act = None
        if tol is not None:
            self.active = torch.ones((), dtype=torch.bool, device=device)
            self.eff = torch.zeros((), dtype=torch.float32, device=device)
        self.device = device
        self.track = track  # telemetry: keep each round's momentum norm
        self.mom_sq = torch.zeros((), dtype=torch.float32, device=device) if track else None

    def gate(self, disagreement: torch.Tensor) -> None:
        """Before a round: it runs while the carried disagreement exceeds
        ``tol`` and no earlier round was gated off."""
        self.act = self.active & (disagreement > self.tol)
        self.active = self.act
        self.eff = self.eff + self.act.float()

    def keep(self, new, old):
        """``new`` where this round runs, else ``old``."""
        if self.tol is None:
            return new
        act = self.act
        return tree_map(lambda n, o: torch.where(act, n, o), new, old)

    def sent(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where this round runs, else 0 (a gated round sends no bytes
        and adds no momentum)."""
        return x if self.tol is None else torch.where(self.act, x, 0.0)

    def finish(self, old, new):
        """The carried iterate after a round from ``old`` whose mixing gave
        ``new``: the momentum term, then the gate; advances ``x_prev``.
        With ``track``, ``mom_sq`` is the round's ``beta^2 ||x - x_prev||^2``
        summed over every row (0 on a gated round)."""
        if self.beta != 0.0:
            beta = self.beta
            mom = tree_map(lambda o, p: o.float() - p.float(), old, self.prev)
            new = tree_map(lambda n, m: (n.float() + beta * m).to(n.dtype), new, mom)
            if self.track:
                self.mom_sq = self.sent(beta * beta * sum(m.square().sum() for m in tree_leaves(mom)))
            self.prev = self.keep(old, self.prev)
        return self.keep(new, old)

    def rounds_run(self, r: int) -> torch.Tensor:
        """Telemetry's ``effective_rounds`` after round ``r``."""
        if self.tol is not None:
            return self.eff
        return torch.tensor(float(r + 1), device=self.device)


def _control_knobs(momentum, round_tol) -> tuple[float, "float | None"]:
    """``(beta, tol)``, validated as the reference validates them."""
    beta = float(momentum)
    if not 0.0 <= beta < 1.0:
        raise ValueError(
            f"consensus momentum must be in [0, 1), got {beta}; the heavy-ball "
            "recurrence diverges at beta >= 1"
        )
    if round_tol is None:
        return beta, None
    tol = float(round_tol)
    if not tol > 0.0:
        raise ValueError(f"round_tol must be > 0, got {tol}")
    return beta, tol


def combine_slab_kernels(layout: packing.SlabLayout, M: torch.Tensor, slab: torch.Tensor):
    """Whole-slab combine through ``slab_combine``: the per-block (K, K)
    matrices are gathered from the static ``layout.block_layer`` map."""
    A_blocks = M.float()[layout.block_layer_on(M.device)].contiguous()
    return slab_combine(A_blocks, slab)


# kernel launches of one per-slot combine on CUDA tensors
COMBINE_PER_SLOT_LAUNCHES = 1  # combine_slab_per_slot: one weighted_combine
DEQUANT_PER_SLOT_LAUNCHES = 1  # dequant_combine_slab_per_slot: one dequant_combine


def combine_slab_per_slot(layout: packing.SlabLayout, A: torch.Tensor, slab: torch.Tensor):
    """Per-slot combine through ``weighted_combine``, the reference's
    ``_combine_slab_per_slot`` (one ``weighted_combine`` per DRT layer
    slot, output agent ``k`` weighted by column ``k`` of the slot's ``A``):
    ONE launch over every slot (:data:`COMBINE_PER_SLOT_LAUNCHES`), each
    slot's columns with its (K, K) matrix, ``A`` read as it lies.  The
    parity partner of :func:`combine_slab_kernels`; returns a new (K, D)
    slab."""
    table = layout.segment_table_on("slots", slab.device)
    return weighted_combine_segments(A.float().transpose(1, 2), slab, table)


def dequant_combine_slab_per_slot(layout: packing.SlabLayout, A_off: torch.Tensor, wire: "SlabQuant"):
    """Per-(slot, leaf) fused int8 dequantize + combine through
    ``dequant_combine``, the reference's ``_dequant_combine_slab_per_slot``
    (one ``dequant_combine`` per slot and leaf, each leaf with its scale
    segment): ONE launch over every piece (:data:`DEQUANT_PER_SLOT_LAUNCHES`),
    which also writes the lane padding's zeros.  The parity partner of
    :func:`dequant_combine_slab_kernels`; returns a new (K, D) f32 slab
    with zero lane padding."""
    table = layout.segment_table_on("leaves", wire.q.device)
    return dequant_combine_segments(A_off.float().transpose(1, 2), wire.s, wire.q, table)


def dequant_combine_slab_kernels(layout: packing.SlabLayout, A_off: torch.Tensor, wire: "SlabQuant"):
    """Fused whole-slab int8 dequantize + combine, the reference's
    ``_dequant_combine_slab_kernels``: ONE ``slab_dequant_combine`` launch,
    each column block's (K, K) matrix read from the (L, K, K) stack through
    the layout's ``block_layer`` map (no per-block copy) and each column's
    scale through its ``col_seg`` map.  The maps' ids are checked on their
    first use only, so a call is one device operation."""
    maps = layout.maps_on(wire.q.device)
    return slab_dequant_combine(A_off.float().contiguous(), wire.s.contiguous(), maps["col_seg"], wire.q,
                                maps["block_layer"])


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
    publish=None,
    a_transform=None,
):
    """One consensus round on the agent-stacked tree, leaf by leaf: the
    reference's ``gather_consensus_step``.

    Exact exchange: ``A`` from the tree's distances (DRT) or the Metropolis
    matrix (classical), then ``LayerPartition.combine``.  With a codec,
    every agent's tree goes through ``encode`` under its key
    ``fold_in(rng, agent)`` (``rng`` two uint32 words; ``key(0)`` for a
    codec that draws no bits) and ``decode``; ``A`` comes from the decoded
    trees, the neighbours enter the combine decoded and each agent's own
    term at full precision.  Returns ``(new_K, A)``, or ``(new_K, A,
    codec_state)`` when ``codec`` is given (top-k: the new residual tree,
    else the incoming state or ``()``).

    ``publish`` (fault injection): the published view of the agent-stacked
    tree; the distances and the off-diagonal combine read it (through the
    codec, as honest traffic), every agent's self term keeps its true row
    of ``psi_K``.  ``a_transform`` post-processes ``A`` (trust clipping and
    temperature) before the combine."""
    wire_codec = None if codec is None else make_codec(codec)
    new, A, state, _, _ = _tree_step(partition, psi_K, C, cfg, algorithm, metropolis, wire_codec, codec_state,
                                     rng, publish, a_transform)
    return (new, A) if codec is None else (new, A, state)


def _tree_step(partition, psi_K, C, cfg, algorithm, metropolis, wire_codec, codec_state, rng, publish,
               a_transform):
    """:func:`gather_consensus_step` with what telemetry reads beside it:
    ``(new_K, A, codec_state, wire_K, d2)``, ``wire_K`` the agents' stacked
    wire (``None`` on the exact exchange), ``d2`` the (L, K, K) distances
    ``A`` came from (``None`` for classical)."""
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    L = partition.num_layers
    C = _matrix(C, "C", K, device)
    if algorithm == "classical":
        if metropolis is None:
            raise ValueError('algorithm="classical" needs metropolis=')
        metropolis = _matrix(metropolis, "metropolis", K, device)
    elif algorithm != "drt":
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def mixing(psi):
        if algorithm == "classical":
            return metropolis.expand(L, K, K), None
        d2, n2 = partition.pairwise_sq_dists(psi)
        A = drt_mod.drt_mixing_matrices(d2, n2, C, cfg)
        return A, d2

    def self_plus(A, off):
        """``off`` plus each agent's own true tree weighted by its diagonal
        of ``A``."""
        diag = torch.diagonal(A, dim1=1, dim2=2)  # (L, K) self weights
        selfed = tree_map(
            lambda *xs: torch.stack(xs),
            *[partition.scale_by_layer(diag[:, k], tree_map(lambda x: x[k], psi_K)) for k in range(K)],
        )
        return tree_map(lambda o, s_: (o.float() + s_.float()).to(s_.dtype), off, selfed)

    eye = torch.eye(K, device=device)
    with torch.no_grad():
        if wire_codec is None or isinstance(wire_codec, IdentityCodec):
            A, d2 = mixing(psi_K if publish is None else publish)
            if a_transform is not None:
                A = a_transform(A)
            if publish is None:
                new = partition.combine(A, psi_K)
            else:  # neighbours see the published tree, each agent its own row
                new = self_plus(A, partition.combine(A * (1.0 - eye), publish))
            return new, A, codec_state if codec_state is not None else (), None, d2
        if wire_codec.stateful and codec_state in (None, ()):
            codec_state = init_comm_state(wire_codec, psi_K)
        elif codec_state is None:
            codec_state = ()
        keys = prng.fold_in(_round_set_key(wire_codec, rng), np.arange(K))  # (K, 2)
        sent_K = psi_K if publish is None else publish
        wires, states = [], []
        for k in range(K):
            state_k = tree_map(lambda x: x[k], codec_state) if wire_codec.stateful else ()
            wire, state = wire_codec.encode(tree_map(lambda x: x[k], sent_K), state_k, keys[k])
            wires.append(wire)
            states.append(state)
        wire_K = tree_map(_stack_wire, *wires)
        psi_hat = wire_codec.decode(wire_K)
        new_state = tree_map(lambda *xs: torch.stack(xs), *states) if wire_codec.stateful else codec_state
        A, d2 = mixing(psi_hat)
        if a_transform is not None:
            A = a_transform(A)
        new = self_plus(A, partition.combine(A * (1.0 - eye), psi_hat))
    return new, A, new_state, wire_K, d2


def _stack_wire(*leaves):
    """Stack one leaf's per-agent wires along a new agent axis (an int8
    wire stacks its values and its scales)."""
    if isinstance(leaves[0], QuantLeaf):
        return QuantLeaf(q=torch.stack([w.q for w in leaves]), s=torch.stack([w.s for w in leaves]))
    return torch.stack(leaves)


def _tree_rounds(partition, psi_K, C_stack, metro_stack, cfg, codec, codec_state, rng, *,
                 rounds, algorithm, obs, beta, tol, faults, reweight):
    """``path="tree"`` of :func:`gather_consensus_rounds`: ``rounds`` calls
    of :func:`gather_consensus_step`, round ``r`` over slice ``r`` of the
    stacks and keyed ``fold_in(rng, r)``, the codec state (top-k's
    residual) threaded through; control on each round's output tree.  An
    attack publishes ``apply_fault_tree`` of the round's iterate under
    ``fold_in(faults.key, r)``; ``reweight`` goes to the step as its
    ``a_transform``.  Telemetry reads the step's wire and distances (the
    reference encodes the round's wire a second time for them)."""
    leaf = tree_leaves(psi_K)[0]
    K, device, L = leaf.shape[0], leaf.device, partition.num_layers
    stateful = codec is not None and codec.stateful
    exact = codec is None or isinstance(codec, IdentityCodec)
    state = codec_state
    if stateful and state in (None, ()):
        state = init_comm_state(codec, psi_K)  # zeros, as the step would start it
    ctl = _Control(beta, tol, psi_K, device, track=obs is not None)
    A = torch.zeros(L, K, K, device=device)
    attack = _Attack(faults, device)
    tel = None
    if obs is not None:
        template = agent_template(psi_K)
        idb = float(IdentityCodec().wire_bytes(template))
        send = torch.tensor(idb, dtype=torch.float32, device=device)
        tel = _Telemetry(ctl, K, idb, K - 1.0)
    for r in range(rounds):
        if tol is not None:
            ctl.gate(obs_metrics.tree_disagreement(psi_K))
        metro_r = None if metro_stack is None else metro_stack[r]
        pub = attack.tree(psi_K, r)
        round_rng = None if codec is None or rng is None else prng.fold_in(rng, r)
        new, A_r, new_state, wire_K, d2 = _tree_step(partition, psi_K, C_stack[r], cfg, algorithm, metro_r,
                                                     codec, state, round_rng, pub, reweight)
        psi_K, A = ctl.finish(psi_K, new), ctl.keep(A_r, A)
        state = ctl.keep(new_state, state) if stateful else new_state
        if tel is not None:
            if not exact:
                send = obs_metrics.tree_wire_send_bytes(codec, wire_K, template).mean()
            tel.add(A, obs_metrics.tree_disagreement(psi_K), send, support=_support(C_stack, metro_stack, r),
                    d2=d2, ef=obs_metrics.tree_mean_sq_norm(state) if stateful else None, byz=attack.mask(r),
                    mom=_mean_mom(ctl, K))
    out = (psi_K, A)
    if codec is not None:
        out += (state,)
    if tel is not None:
        out += (tel.metrics(),)
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

    ``C`` and ``metropolis`` may be per-round ``(rounds, K, K)`` stacks
    (``TopologySchedule.mixing_stacks``): round ``r`` mixes over slice
    ``r`` on every path.  ``momentum`` (in [0, 1)) and ``round_tol`` (> 0)
    are the consensus control of the module docstring, on every path.

    Robustness (:mod:`repro_torch.faults`; the module docstring):
    ``faults`` (a :class:`~repro_torch.faults.FaultRealization` of this
    round-set, ``FaultPlan.realize``) makes masked agents publish a faulted
    view of their iterate, and stale senders re-publish the previous
    round's (slab and edge paths); ``trust_clip`` / ``trust_temp`` reweight
    each round's mixing matrices (``reweight_dense``; on the edge path the
    edge factors, ``reweight_edge``); ``combine="trimmed:<f>" | "median"``
    (slab path only) replaces the weighted combine by a coordinate-wise
    robust one, ``A_last`` and telemetry then reporting the
    support-uniform weights.  Message drop is a schedule
    (``faults.DropSchedule``) and needs nothing here.

    Telemetry (``obs``, an :class:`~repro_torch.obs.metrics.ObsConfig`):
    every path returns the full per-round record (the metrics module's
    docstring) and launches no kernel more than without it;
    ``obs.annotate`` names the slab phases for a profiler trace.
    """
    wire_codec = None if codec is None else make_codec(codec)
    if path not in ("slab", "edge", "tree"):
        raise ValueError(f"unknown consensus path {path!r}")
    if path == "edge" and edges is None:
        raise ValueError(
            'path="edge" needs edges= (an EdgeStacks round stack, e.g. '
            "dynamic.edge_stacks_from_topology)"
        )
    robust.validate_trust_knobs(trust_clip, trust_temp)
    reweight = None
    if trust_clip is not None or trust_temp is not None:
        reweight = functools.partial(robust.reweight_dense, clip=trust_clip, temp=trust_temp)
    combine_kind, combine_frac = robust.parse_combine(combine)
    if combine_kind != "drt" and path != "slab":
        raise ValueError(
            f"combine={combine!r} needs the dense slab path (robust combines sort each "
            f"agent's full neighbourhood), got path={path!r}"
        )
    if rounds < 1:
        raise ValueError(
            f"gather_consensus_rounds needs rounds >= 1, got {rounds}; "
            "skip the call entirely for a consensus-free step"
        )
    beta, tol = _control_knobs(momentum, round_tol)
    if algorithm not in ("drt", "classical"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    faults = _check_faults(faults, rounds, K, path)
    C_stack = _round_stack(C, rounds, "C", K, device)
    metro_stack = _round_stack(metropolis, rounds, "metropolis", K, device)
    if algorithm == "classical" and metro_stack is None and path != "edge":
        raise ValueError('algorithm="classical" needs metropolis=')
    control = dict(beta=beta, tol=tol)
    if path == "tree":
        return _tree_rounds(
            partition, psi_K, C_stack, metro_stack, cfg, wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs, faults=faults, reweight=reweight, **control,
        )
    if layout is None:
        layout = packing.build_slab_layout(partition, agent_template(psi_K))
    if path == "edge":
        return _edge_rounds(
            layout, psi_K, edges, max_in_degree, cfg, wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs, faults=faults,
            trust=None if reweight is None else (trust_clip, trust_temp), **control,
        )
    exact = wire_codec is None or isinstance(wire_codec, IdentityCodec)
    if faults is not None or combine_kind != "drt" or (reweight is not None and not exact):
        new_K, A, state, metrics = _faulted_rounds(
            layout, psi_K, C_stack, metro_stack, cfg, None if exact else wire_codec, codec_state, rng,
            rounds=rounds, algorithm=algorithm, obs=obs, faults=faults, reweight=reweight,
            combine=(combine_kind, combine_frac), **control,
        )
        out = (new_K, A)
        if wire_codec is not None:
            out += (state if not exact else codec_state if codec_state is not None else (),)
        if obs is not None:
            out += (metrics,)
        return out
    if not exact:
        return _coded_rounds(
            layout, psi_K, C_stack if algorithm == "drt" else metro_stack, cfg, wire_codec,
            codec_state, rng, C_stack, rounds=rounds, algorithm=algorithm, obs=obs, **control,
        )
    new_K, A, metrics = _exact_rounds(
        layout, psi_K, C_stack, metro_stack, cfg, rounds=rounds, algorithm=algorithm, obs=obs,
        reweight=reweight, **control,
    )
    out = (new_K, A)
    if wire_codec is not None:  # the identity codec: its state passes through
        out += (codec_state if codec_state is not None else (),)
    if obs is not None:
        out += (metrics,)
    return out


def _exact_rounds(layout, psi_K, C_stack, metro_stack, cfg, *, rounds, algorithm, obs, beta, tol,
                  reweight=None):
    """The exact branch of :func:`gather_consensus_rounds` (module
    docstring): the Gram recurrence and ONE combine.  Under control the
    accumulated product carries the momentum and the gate, and each
    round's Gram is ``gram_update(G0, M)`` off the constant initial one.
    Trust reweighting is linear in the iterates: each round's ``A`` is
    reweighted, then ``M' = M A``.  Telemetry reads the round's distances
    and disagreement off the Gram, and the momentum term's norm off
    ``beta^2 tr(dM^T G0 dM)``, ``dM = M - M_prev``.  Returns ``(new_K,
    A_last, metrics or None)``."""
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    L = layout.num_layers
    with torch.no_grad():
        with scope(obs, "consensus.pack"):
            slab = layout.pack(psi_K)
        need_G = algorithm == "drt" or obs is not None or tol is not None
        G0 = G = layout.gram(layout.split(slab)) if need_G else None
        M = torch.eye(K, device=device).expand(L, K, K)
        ctl = _Control(beta, tol, M, device)
        A = torch.zeros(L, K, K, device=device)
        tel = None
        if obs is not None:
            idb = obs_metrics.slab_identity_bytes(layout)
            send = torch.tensor(idb, dtype=torch.float32, device=device)
            tel = _Telemetry(ctl, K, idb, K - 1.0)
        for r in range(rounds):
            if ctl.on and need_G:
                G = packing.gram_update(G0, M)  # the carried iterate's Gram
            if tol is not None:
                ctl.gate(packing.gram_disagreement(G))
            if algorithm == "drt" or obs is not None:
                d2, n2 = packing.gram_sq_dists(G)
            if algorithm == "classical":
                A_r = metro_stack[r].expand(L, K, K)
            else:
                A_r = drt_mod.drt_mixing_matrices(d2, n2, C_stack[r], cfg)
            if reweight is not None:
                A_r = reweight(A_r)
            M_new = torch.bmm(M, A_r)
            mom = None
            if ctl.on:
                if obs is not None and beta != 0.0:
                    dM = M - ctl.prev
                    mom = ctl.sent(beta * beta * torch.diagonal(packing.gram_update(G0, dM), dim1=1, dim2=2).sum()
                                   / K)
                M_new, A_r = ctl.finish(M, M_new), ctl.keep(A_r, A)
                G_after = packing.gram_update(G0, M_new) if obs is not None else None
            elif need_G:
                G = G_after = packing.gram_update(G, A_r)
            M, A = M_new, A_r
            if tel is not None:
                tel.add(A, packing.gram_disagreement(G_after), send, support=_support(C_stack, metro_stack, r),
                        d2=d2, mom=mom)
        with scope(obs, "consensus.combine"):
            out = combine_slab_kernels(layout, M, slab)
        # the packed slab is read for the last time: free it before the
        # unpack's copies (four full-width qwen3-4b agents: 15.7 GB)
        del slab
        with scope(obs, "consensus.unpack"):
            new_K = layout.unpack(out, like=psi_K)
    return new_K, A, None if tel is None else tel.metrics()


def _faulted_rounds(layout, psi_K, C_stack, metro_stack, cfg, codec, codec_state, rng, *,
                    rounds, algorithm, obs, beta, tol, faults, reweight, combine):
    """The per-round slab body of :func:`gather_consensus_rounds` under
    faults, a robust combine, or trust reweighting of a coded exchange (the
    reference's non-fused round): each round publishes (stale rows, then
    the attack), encodes (int8: one ``slab_quant_encode``) and decodes,
    derives ``A`` from the decoded slab's Gram (or takes the Metropolis
    matrix), reweights it and combines: ONE ``slab_combine`` of the decoded
    published slab over ``A``'s off-diagonal plus each agent's true self
    term, or (``combine`` trimmed / median) the robust combine, no kernel.
    ``codec`` is ``None`` for the exact exchange.  The slab's lane padding
    carries what a publication puts there (a Gauss or constant attack), as
    the reference's regions do; the int8 wire, as the reference's, has
    zeros there.  Returns ``(new_K, A_last, state, metrics)``, ``state``
    the unpacked top-k residual or ``()``, ``metrics`` ``None`` without
    ``obs``."""
    kind, frac = combine
    mode = None if codec is None else _wire_mode(codec)
    if codec is not None:
        rng = _round_set_key(codec, rng)
    leaf = tree_leaves(psi_K)[0]
    K, device = leaf.shape[0], leaf.device
    L = layout.num_layers
    attack = _Attack(faults, device)
    with torch.no_grad():
        with scope(obs, "consensus.pack"):
            slab = layout.pack(psi_K)
        res = None if codec is None else _packed_residual(codec, codec_state, layout, K, device)
        ctl = _Control(beta, tol, slab, device, track=obs is not None)
        prev_pub = slab  # what a stale sender re-publishes: the previous round's iterate
        A = torch.zeros(L, K, K, device=device)
        tel = None
        if obs is not None:
            idb = obs_metrics.slab_identity_bytes(layout)
            send = torch.tensor(idb, dtype=torch.float32, device=device)
            tel = _Telemetry(ctl, K, idb, K - 1.0)
        for r in range(rounds):
            if tol is not None:
                ctl.gate(packing.slab_disagreement(slab, layout))
            pub = attack.slab(layout, slab, prev_pub, r)
            new_res, d2 = res, None
            if codec is None:
                with scope(obs, "consensus.decode"):
                    dec = pub
            else:
                with scope(obs, "consensus.encode"):
                    if mode == "int8" and pub is not slab:
                        pub = pub.index_fill(1, layout.pad_cols_on(device), 0.0)  # the wire's padding is 0
                    keys = prng.fold_in(prng.fold_in(rng, r), np.arange(K))  # (K, 2) agent keys
                    wire, new_res = slab_encode_batched(codec, layout, pub, res, keys)
                with scope(obs, "consensus.decode"):
                    dec = slab_decode(codec, layout, wire).contiguous()
            if kind != "drt":
                A_r = robust.support_uniform(C_stack[r], L)
                with scope(obs, "consensus.combine"):
                    new = robust.robust_combine(C_stack[r], dec, kind, frac)
            else:
                if algorithm == "classical":
                    A_r = metro_stack[r].expand(L, K, K)
                else:
                    d2, n2 = packing.gram_sq_dists(layout.gram(layout.split(dec)))
                    A_r = drt_mod.drt_mixing_matrices(d2, n2, C_stack[r], cfg)
                if reweight is not None:
                    A_r = reweight(A_r)
                with scope(obs, "consensus.combine"):
                    new = _off_plus_self(layout, A_r, dec, slab)
            new_slab = ctl.finish(slab, new)
            A = ctl.keep(A_r, A)
            res = None if res is None else ctl.keep(new_res, res)
            prev_pub = ctl.keep(slab, prev_pub)
            slab = new_slab
            if tel is not None:
                if codec is not None:
                    send = obs_metrics.slab_wire_send_bytes(codec, layout, wire).mean()
                tel.add(A, packing.slab_disagreement(slab, layout), send, support=_support(C_stack, metro_stack, r),
                        d2=d2, ef=_mean_sq(res), byz=attack.mask(r), mom=_mean_mom(ctl, K))
        with scope(obs, "consensus.unpack"):
            new_K = layout.unpack(slab, like=psi_K)
            state = () if res is None else layout.unpack(res, like=psi_K, dtype=torch.float32)
    return new_K, A, state, None if tel is None else tel.metrics()


def _mean_sq(res: "torch.Tensor | None") -> "torch.Tensor | None":
    """Mean per-row squared norm of a (K, D) residual slab, ``None`` for
    none."""
    return None if res is None else res.float().square().sum() / res.shape[0]


def _mean_mom(ctl: _Control, K: int) -> "torch.Tensor | None":
    """The round's mean per-agent momentum norm, ``None`` without
    momentum."""
    return None if ctl.beta == 0.0 else ctl.mom_sq / K


def _off_plus_self(layout, A: torch.Tensor, dec: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """``A``'s off-diagonal combine of the decoded slab ``dec`` (ONE
    ``slab_combine`` on a CUDA slab) plus each agent's true slab weighted by
    its diagonal entry, layer by layer (elementwise)."""
    K, D = slab.shape
    eye = torch.eye(K, device=slab.device)
    off = combine_slab_kernels(layout, A * (1.0 - eye), dec)
    self_w = torch.diagonal(A, dim1=1, dim2=2)[layout.block_layer_on(slab.device)]  # (n_blocks, K)
    selfed = slab.view(K, -1, layout.lane) * self_w.t()[:, :, None]
    return off + selfed.view(K, D)


def _wire_mode(codec) -> str:
    """The ``slab_encode_combine`` mode of a codec."""
    if isinstance(codec, Int8StochasticCodec):
        return "int8"
    if isinstance(codec, TopKCodec):
        return "sent"
    if isinstance(codec, CastCodec) and codec.dtype in (torch.bfloat16, torch.float16):
        return "bf16" if codec.dtype == torch.bfloat16 else "f16"
    raise NotImplementedError(f"codec {codec!r} has no slab path in the port")


def _coded_rounds(layout, psi_K, mix, cfg, codec, codec_state, rng, C_stack, *,
                  rounds, algorithm, obs, beta, tol):
    """The coded branch of :func:`gather_consensus_rounds` (see the module
    docstring): one ``slab_encode_combine`` call per round, over ``mix[r]``
    (C for DRT, the Metropolis matrix for classical); control on each
    round's output slab.  Telemetry's distances come from the Gram the
    call returns (DRT; a classical round has none)."""
    mode = _wire_mode(codec)
    rng = _round_set_key(codec, rng)
    K = mix.shape[1]
    device = mix.device
    kw = dict(mode=mode, algorithm=algorithm, num_layers=layout.num_layers,
              kappa=cfg.kappa, N_clip=cfg.resolve_N(K), weight_mode=cfg.weight_mode)
    if mode == "int8":
        kw["qmax"] = codec.qmax
    bl = layout.maps_on(device)["block_layer"]
    gram = obs is not None and algorithm == "drt"
    with torch.no_grad():
        with scope(obs, "consensus.pack"):
            slab = layout.pack(psi_K)
        res = _packed_residual(codec, codec_state, layout, K, device)
        ctl = _Control(beta, tol, slab, device, track=obs is not None)
        A = torch.zeros(layout.num_layers, K, K, device=device)
        tel = None
        if obs is not None:
            idb = obs_metrics.slab_identity_bytes(layout)
            if mode != "sent":
                send = torch.tensor(obs_metrics.slab_static_wire_bytes(codec, layout), dtype=torch.float32,
                                    device=device)
            tel = _Telemetry(ctl, K, idb, K - 1.0)
        for r in range(rounds):
            if tol is not None:
                ctl.gate(packing.slab_disagreement(slab, layout))
            keys = prng.fold_in(prng.fold_in(rng, r), np.arange(K))  # (K, 2) agent keys
            new_res = res
            with scope(obs, "consensus.encode"):
                if mode == "int8":
                    wire = packing.int8_wire_operands(codec, layout, slab, keys)
                elif mode == "sent":
                    sent, new_res = slab_encode_batched(codec, layout, slab, res, keys)
                    wire = (sent,)
                else:
                    wire = ()
            with scope(obs, "consensus.combine"):
                new, A_r, *G = slab_encode_combine(bl, slab, wire, mix[r], return_gram=gram, **kw)
            slab, A = ctl.finish(slab, new), ctl.keep(A_r, A)
            res = None if res is None else ctl.keep(new_res, res)
            if tel is not None:
                if mode == "sent":
                    send = obs_metrics.slab_wire_send_bytes(codec, layout, sent).mean()
                tel.add(A, packing.slab_disagreement(slab, layout), send, support=_support(C_stack, mix, r),
                        gram=G[0] if gram else None, ef=_mean_sq(res), mom=_mean_mom(ctl, K))
        with scope(obs, "consensus.unpack"):
            new_K = layout.unpack(slab, like=psi_K)
            state = layout.unpack(res, like=psi_K, dtype=torch.float32) if codec.stateful else ()
    if tel is None:
        return new_K, A, state
    return new_K, A, state, tel.metrics()


def _edge_rounds(layout, psi_K, edges, max_in_degree, cfg, codec, codec_state, rng, *,
                 rounds, algorithm, obs, beta, tol, faults, trust):
    """The edge branch of :func:`gather_consensus_rounds` (module
    docstring): one ``slab_edge_encode_combine`` (or, without
    ``max_in_degree``, ``slab_edge_combine``) call per round; control on
    each round's output slab.

    Faults as the reference's edge round: stale senders re-publish the
    previous round's iterate, then the masked agents' attack rewrites the
    published slab, which goes on the wire (the int8 wire with zero lane
    padding) while each agent's self term reads its true slab: the kernels
    take the two apart (``self_slab`` and the wire).  ``trust`` =
    ``(clip, temp)`` reweights the edge factors between the call's factors
    launch and its combine launch (``faults.reweight_edge``).  Telemetry's
    distances are the call's per-edge ``d2e`` (DRT)."""
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
              N_clip=cfg.resolve_N(K), weight_mode=cfg.weight_mode, return_d2e=obs is not None and algorithm == "drt")
    attack = _Attack(faults, device)
    with torch.no_grad():
        with scope(obs, "consensus.pack"):
            slab = layout.pack(psi_K)
        res = None if exact else _packed_residual(codec, codec_state, layout, K, device)
        ctl = _Control(beta, tol, slab, device, track=obs is not None)
        prev_pub = slab  # what a stale sender re-publishes: the previous round's iterate
        A = torch.zeros(layout.num_layers, K, K, device=device)
        tel = None
        if obs is not None:
            idb = obs_metrics.slab_identity_bytes(layout)
            if exact or mode != "sent":
                send = torch.tensor(obs_metrics.slab_static_wire_bytes(None if exact else codec, layout),
                                    dtype=torch.float32, device=device)
            tel = _Telemetry(ctl, K, idb, None)
        for r in range(rounds):
            if tol is not None:
                ctl.gate(packing.slab_disagreement(slab, layout))
            src, dst, w = src_r[r].contiguous(), dst_r[r].contiguous(), w_r[r].contiguous()
            pub = attack.slab(layout, slab, prev_pub, r)
            new_res = res
            if exact:
                wire, ops = pub, (pub,)
            else:
                with scope(obs, "consensus.encode"):
                    if mode == "int8" and pub is not slab:
                        pub = pub.index_fill(1, layout.pad_cols_on(device), 0.0)  # the wire's padding is 0
                    keys = prng.fold_in(prng.fold_in(rng, r), np.arange(K))  # (K, 2) agent keys
                    wire, new_res = slab_encode_batched(codec, layout, pub, res, keys)
                ops = (wire.q, wire.s, maps["col_seg"]) if mode == "int8" else (wire,)
            reweight = None
            if trust is not None:
                def reweight(a_self, a_e, dst=dst):
                    return robust.reweight_edge(a_self, a_e, dst, K, *trust)
            if max_in_degree is not None:
                nbr, pos, valid, _ = csr_from_edges(src, dst, w, K, max_in_degree)
                with scope(obs, "consensus.combine"):
                    new, A_self, A_e, *d2e = slab_edge_encode_combine(
                        bl, slab, ops, src, dst, w, nbr, pos, valid, mode=mode, reweight=reweight, **kw
                    )
            else:
                with scope(obs, "consensus.decode"):
                    dec = pub if exact else slab_decode(codec, layout, wire)
                with scope(obs, "consensus.combine"):
                    new, A_self, A_e, *d2e = slab_edge_combine(bl, slab, dec, src, dst, w, reweight=reweight,
                                                               **kw)
            A_r = edge_mixing_dense(A_self, A_e, src, dst, w, K)
            new_slab = ctl.finish(slab, new)
            A = ctl.keep(A_r, A)
            res = None if res is None else ctl.keep(new_res, res)
            prev_pub = ctl.keep(slab, prev_pub)
            slab = new_slab
            if tel is not None:
                if mode == "sent":
                    send = obs_metrics.slab_wire_send_bytes(codec, layout, wire).mean()
                tel.add(A, packing.slab_disagreement(slab, layout), send, edges=(src, dst, w),
                        d2e=d2e[0] if d2e else None, ef=_mean_sq(res), byz=attack.mask(r), mom=_mean_mom(ctl, K))
        with scope(obs, "consensus.unpack"):
            new_K = layout.unpack(slab, like=psi_K)
            state = None if res is None else layout.unpack(res, like=psi_K, dtype=torch.float32)
    out = (new_K, A)
    if state is not None:
        out += (state,)
    elif codec is not None:
        out += (codec_state if codec_state is not None else (),)
    if tel is not None:
        out += (tel.metrics(),)
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


def _support(C_stack, mix_stack, r: int) -> torch.Tensor:
    """Round ``r``'s support for telemetry's ``suspicion``: ``C``'s slice,
    else the mixing stack's (the reference's ``C_r if C_r is not None else
    metro_r``)."""
    return (C_stack if C_stack is not None else mix_stack)[r]


class _Telemetry:
    """A gather round-set's telemetry: each round's raw pieces (the mixing
    matrices, the realized support, the distances, the wire bytes, ...)
    kept as the round leaves them, and the record made from all rounds at
    once in :meth:`metrics` (a few dozen small calls a round-set, not a
    round: the engine is host-bound)."""

    def __init__(self, ctl: _Control, K: int, idb: float, n_recv: "float | None"):
        """``idb``: an agent's f32-equivalent bytes; ``n_recv``: the wires
        an agent receives per wire it sends (``None`` on the edge path,
        where it is each round's mean in-degree)."""
        self.ctl, self.K, self.idb, self.n_recv = ctl, K, idb, n_recv
        self.rows = []

    def add(self, A, disagreement, send, *, support=None, edges=None, d2=None, gram=None, d2e=None, ef=None,
            byz=None, mom=None):
        """A round's pieces: ``A`` (L, K, K); the support ``(K, K)`` or,
        on the edge path, ``edges = (src, dst, w)``; the distances as ``d2``
        (L, K, K), a Gram ``gram`` (L, K, K) or the edge path's ``d2e`` (L,
        E), none for zeros; ``send`` the mean per-agent wire bytes; ``ef``
        the residual's and ``mom`` the momentum term's mean per-agent
        squared norm; ``byz`` the Byzantine membership; ``None`` for a
        field's zeros."""
        ctl = self.ctl
        gated = ctl.tol is not None
        self.rows.append(dict(A=A, dis=disagreement, send=send, support=support, edges=edges, d2=d2, gram=gram,
                              d2e=d2e, ef=ef, byz=byz, mom=mom, act=ctl.act if gated else None,
                              eff=ctl.eff if gated else None))

    def metrics(self) -> ConsensusMetrics:
        rows, K = self.rows, self.K
        R = len(rows)

        def stacked(key):
            vals = [row[key] for row in rows]
            return None if vals[0] is None else torch.stack(vals)

        A = stacked("A")
        dev, L = A.device, A.shape[1]
        zeros = torch.zeros(R, dtype=torch.float32, device=dev)
        send = stacked("send")
        if rows[0]["act"] is not None:  # a round the gate turned off sends nothing
            send_w = torch.where(stacked("act"), send, 0.0)
            rounds_run = stacked("eff")
        else:
            send_w = send
            rounds_run = torch.arange(1, R + 1, dtype=torch.float32, device=dev)
        if rows[0]["edges"] is not None:  # the edge path: the realized directed edges
            src, dst, w = (torch.stack(t) for t in zip(*(row["edges"] for row in rows)))
            mask = (w > 0.0).float()
            n_dir = mask.sum(-1)
            rr = torch.arange(R, device=dev)[:, None].expand_as(src)
            support = torch.zeros(R, K, K, device=dev).index_put_((rr, src.long(), dst.long()), mask,
                                                                  accumulate=True)
            edges, n_recv = n_dir / 2.0, n_dir / K
        else:
            support = stacked("support")
            edges, n_recv = obs_metrics.edge_count(support), self.n_recv
        d2m = d2x = torch.zeros(R, L, dtype=torch.float32, device=dev)
        if rows[0]["d2"] is not None:
            d2m, d2x = obs_metrics.d2_summaries(stacked("d2"))
        elif rows[0]["gram"] is not None:
            G = stacked("gram")
            n2 = torch.diagonal(G, dim1=-2, dim2=-1)  # packing.gram_sq_dists over a leading rounds axis
            d2m, d2x = obs_metrics.d2_summaries(torch.clamp(n2[..., :, None] + n2[..., None, :] - 2.0 * G, min=0.0))
        elif rows[0]["d2e"] is not None:  # the distances the sparse round computed, over its real edges
            d = stacked("d2e") * mask[:, None, :]
            d2m, d2x = d.sum(-1) / torch.clamp(n_dir, min=1.0)[:, None], d.amax(-1)
        ef, mom, byz = stacked("ef"), stacked("mom"), stacked("byz")
        return ConsensusMetrics(
            disagreement=stacked("dis"),
            layer_d2_mean=d2m,
            layer_d2_max=d2x,
            mix_entropy=obs_metrics.mixing_entropy(A),
            ef_residual=zeros if ef is None else ef,
            wire_send_bytes=send_w,
            wire_recv_bytes=n_recv * send_w,
            compression_ratio=torch.full_like(send, self.idb) / torch.clamp(send, min=1.0),
            edges=edges,
            effective_rounds=rounds_run,
            momentum_norm=zeros if mom is None else mom,
            suspicion=obs_metrics.suspicion_from_A(A, support),
            byzantine_weight_mass=zeros if byz is None else obs_metrics.byzantine_weight_mass(A, byz),
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


def _matrix(mat, name: str, K: int, device) -> torch.Tensor:
    """One round's (K, K) mixing structure as an f32 tensor on ``device``."""
    t = torch.as_tensor(mat, dtype=torch.float32, device=device)
    if tuple(t.shape) != (K, K):
        raise ValueError(f"{name} must be ({K}, {K}), got {tuple(t.shape)}")
    return t


def _round_stack(mat, rounds: int, name: str, K: int, device) -> "torch.Tensor | None":
    """A mixing structure as a ``(rounds, K, K)`` f32 stack on ``device``
    (the reference's ``_round_stack``): a (K, K) matrix broadcast, so every
    round reads the same values, or a per-round stack as it is; ``None``
    passes through."""
    if mat is None:
        return None
    t = torch.as_tensor(mat, dtype=torch.float32, device=device)
    if t.dim() == 3 and t.shape[0] != rounds and tuple(t.shape[1:]) == (K, K):
        raise ValueError(f"per-round {name} stack has {t.shape[0]} rounds, round-set runs {rounds}")
    if t.dim() == 2 and tuple(t.shape) == (K, K):
        return t.expand(rounds, K, K)
    if tuple(t.shape) != (rounds, K, K):
        raise ValueError(f"{name} must be ({K}, {K}) or ({rounds}, {K}, {K}), got {tuple(t.shape)}")
    return t.contiguous()


def _check_faults(faults, rounds: int, K: int, path: str):
    """A round-set's fault realization validated as the reference validates
    it (``None`` when it enables nothing)."""
    if faults is None or (faults.mask is None and faults.stale is None):
        return None
    for name in ("mask", "stale"):
        arr = getattr(faults, name)
        if arr is not None and tuple(arr.shape) != (rounds, K):
            raise ValueError(
                f"faults.{name} must be (rounds, K) = ({rounds}, {K}), got {tuple(arr.shape)}: "
                "realize the plan with the round-set's own start and rounds"
            )
    if faults.mask is not None and faults.model is None:
        raise ValueError("faults with a Byzantine mask need a fault model")
    if faults.stale is not None and path == "tree":
        raise ValueError('stale-iterate delivery is not supported on the tree oracle path (use path="slab")')
    return faults


class _Attack:
    """A round-set's published views (``faults`` may be ``None``): round
    ``r``'s masked agents publish through the fault model under
    ``fold_in(key, r)``, its stale senders re-publish the previous round's
    iterate first."""

    def __init__(self, faults, device):
        self.on = faults is not None and faults.mask is not None
        self.stale = None if faults is None or faults.stale is None else faults.stale.to(device)
        if self.on:
            self.model, self.key = faults.model, faults.key
            self.masks = faults.mask.to(device)
            host = faults.mask_host if faults.mask_host is not None else faults.mask.cpu().numpy()
            self.rows = [np.flatnonzero(m) for m in np.asarray(host, bool)]

    def mask(self, r: int):
        """Round ``r``'s (K,) membership, ``None`` without an attack."""
        return self.masks[r] if self.on else None

    def tree(self, psi_K, r: int):
        """Round ``r``'s published tree, ``None`` without an attack."""
        if not self.on:
            return None
        return fault_models.apply_fault_tree(self.model, psi_K, self.masks[r], prng.fold_in(self.key, r),
                                             rows=self.rows[r])

    def slab(self, layout, slab, prev, r: int):
        """Round ``r``'s published (K, D) slab: stale rows from ``prev``,
        then the attack."""
        pub = slab
        if self.stale is not None:
            pub = torch.where(self.stale[r][:, None], prev, pub)
        if self.on:
            pub = fault_models.apply_fault_regions(self.model, layout, pub, self.masks[r],
                                                   prng.fold_in(self.key, r), rows=self.rows[r])
        return pub


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
    mask: torch.Tensor  # (n,) real neighbour (not a phantom pair)
    log_cw: "torch.Tensor | None"  # DRT: (n,) log of the edge weight (0 on phantoms)
    log_ckk: "float | None"  # DRT: log(c_kk / n_eff); None for an isolated agent


class _RoundCtx(NamedTuple):
    """A realized graph's exchange structure and every rank's mixing
    column on one device (``PermuteConsensus._plan``)."""

    perms: list  # per exchange: the (src, dst) pair list for ppermute
    cols: list  # per rank: its _RankColumn
    edges: float  # the graph's undirected edges (telemetry)


def _exchange_structure(topology: Topology):
    """``(perms, inv_srcs)`` of a graph: per exchange the ppermute pair
    list and each receiver's source agent (itself on a phantom pair)."""
    decomp = exchange_decomposition(topology)
    perms = [[(int(s), int(p[s])) for s in range(len(p))] for p in decomp]
    inv_srcs = []
    for p in decomp:
        inv = np.empty(len(p), np.int64)
        inv[p] = np.arange(len(p))
        inv_srcs.append(inv)
    return perms, inv_srcs


@dataclasses.dataclass(frozen=True)
class PermuteConsensus:
    """Neighbour-exchange consensus engine, one agent per rank (module
    docstring), on the slab path or (``path="tree"``) leaf by leaf.

    Each rank calls ``engine(psi_local, exchange, codec_state, rng,
    rounds=..., start_round=...)`` with its own single-agent tree (no agent
    axis) and its exchange (``repro_torch.comm.exchange``; ``rank`` is the
    agent).  Tensors stay on the device they arrive on: CPU tensors take
    the kernels' plain versions, CUDA tensors launch the kernels or raise.

    ``schedule`` (a ``dynamic.TopologySchedule``): round ``r`` exchanges
    over ``schedule.topology_at(start_round + r)``, decomposed by
    :func:`exchange_decomposition` (matchings for a churned graph; an
    agent left unmatched receives itself and weighs it 0, so a dropped
    agent keeps its iterate).  A round's exchanges and every rank's mixing
    column are built once per realized round of the schedule's period and
    shared by the ranks.  ``momentum`` and ``round_tol``: the control of
    :func:`gather_consensus_rounds`; the gate reads the global disagreement
    ``mean_k ||x_k - x_bar||^2`` through ``exchange.psum`` (one D-sized sum
    a round) and applies through ``torch.where``, so every rank exchanges
    every round in lockstep.  A round with no edge anywhere exchanges and
    combines nothing (a stateful codec's residual still advances) and
    counts as skipped: no momentum step, no budget.

    On the slab path a round-set of R rounds with exchanges makes, per
    rank, one ``drt_dist`` launch per exchange over all L layer slots (none
    for classical; a phantom pair costs its launch too), one
    ``slab_source_combine`` launch and, for int8, one ``slab_quant_encode``
    launch (the rank's wire) a round.  The tree path launches no kernel:
    any codec, any tree, plain tensor ops on the tensors' device.  A codec
    or tree without a slab form raises on the slab path (the reference
    reroutes such a call to its tree path quietly).

    ``trust_clip`` / ``trust_temp`` reweight each rank's local mixing
    column (``faults.reweight_local``) before the combine, on both paths.
    Fault injection belongs to the gather engine, as in the reference.

    Telemetry (``obs=``, both paths): each rank's per-round
    :class:`~repro_torch.obs.metrics.ConsensusMetrics`, its own view as in
    the reference: the distances over its neighbours, its column's entropy,
    its wire bytes (one send and one receive an exchange), residual and
    momentum norms; the disagreement is the global ``mean_k ||x_k -
    x_bar||^2`` (one D-sized ``psum`` a round); ``suspicion`` and
    ``byzantine_weight_mass`` are zeros.  A classical slab round-set under
    ``obs`` launches ``drt_dist`` per exchange for the distances (a DRT one
    launches it anyway).

    Not ported (``NotImplementedError``, naming the ROADMAP.md Queue 1
    item, on both paths): a non-empty ``norm_reduce_axes``.
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

    def _plan(self, t: int, L: int, dev) -> _RoundCtx:
        """Round ``t``'s exchange structure and every rank's mixing column
        on ``dev``: built once (per realized round of a dynamic schedule's
        period, else once) under the engine's lock, shared by every rank."""
        dynamic = self.schedule is not None and not self.schedule.static
        key = ("plan", t % self.schedule._host_edge_period() if dynamic else None, L, dev)
        with self._lock:
            ctx = self._cache.get(key)
            if ctx is None:
                topo = self.topology if self.schedule is None else self.schedule.topology_at(t)
                perms, inv_srcs = _exchange_structure(topo)
                C = topo.c_matrix().astype(np.float32)
                metro = topo.metropolis().astype(np.float32)
                cols = [self._rank_column(inv_srcs, C, metro, k, L, dev) for k in range(topo.num_agents)]
                ctx = self._cache[key] = _RoundCtx(perms, cols, float(np.sum(topo.adjacency)) / 2.0)
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

    def _rank_column(self, inv_srcs, C, metro, my: int, L: int, dev) -> "_RankColumn":
        """Agent ``my``'s mixing-column pieces of a realized graph, on
        ``dev``: its source per exchange, the support weights ``C`` and the
        Metropolis matrix ``metro`` (f32)."""
        srcs = np.array([inv[my] for inv in inv_srcs], np.int64)
        cw = np.where(srcs != my, C[srcs, my], np.float32(0.0)).astype(np.float32)
        mask = cw > 0  # cw = 0: a phantom pair (the agent received itself)
        n_eff = int(mask.sum())  # the surviving neighbourhood
        mask_t = torch.from_numpy(mask).to(dev)
        if self.algorithm == "classical":
            w_nbrs = np.where(mask, metro[srcs, my], np.float32(0.0)).astype(np.float32)
            w = np.concatenate([[metro[my, my]], w_nbrs]).astype(np.float32)
            return _RankColumn(torch.from_numpy(np.repeat(w[:, None], L, axis=1)).to(dev), mask_t, None, None)
        log_cw = np.log(np.where(mask, cw, np.float32(1.0)))
        # the self term log(c_kk / n_eff), f32 as the reference rounds it
        log_ckk = float(np.log(C[my, my] / np.float32(max(n_eff, 1))))
        return _RankColumn(None, mask_t, torch.from_numpy(log_cw).to(dev), log_ckk if n_eff > 0 else None)

    def _mix_weights(self, col: "_RankColumn", d2, n2):
        """The local column of A, ``(1 + n_exchanges, L)`` f32 (self first),
        from the exchanges' stats ``d2`` / ``n2`` (n_exchanges, L); every
        constant rounded to f32 as the reference computes it; then the
        trust reweighting, when a knob is set."""
        w_all = self._drt_column(col, d2, n2) if col.fixed is None else col.fixed
        if self.trust_clip is None and self.trust_temp is None:
            return w_all
        w_self, w_nbrs = robust.reweight_local(w_all[0], w_all[1:], self.trust_clip, self.trust_temp)
        return torch.cat([w_self[None], w_nbrs])

    def _drt_column(self, col: "_RankColumn", d2, n2):
        """DRT eqs. 12-14 on one rank's column (see :meth:`_mix_weights`)."""
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
                 start_round: int = 0, obs=None):
        """Run ``rounds`` consensus rounds for ``exchange.rank``'s agent.

        ``psi_local``: the agent's single-agent tree (no leading agent
        axis).  ``rng``: the round-set's key, two uint32 words
        (``repro_torch.comm.prng``), the same on every rank; round ``r``'s
        wire key is ``fold_in(fold_in(rng, r), rank)``.  ``start_round``:
        the global index of round 0 (a Python int) in the ``schedule``.
        Returns the combined tree, or ``(tree, codec_state)`` when the
        engine has a codec (top-k: the f32 residual tree; else
        ``codec_state`` or ``()``); with ``obs`` the rank's metrics follow
        (class docstring)."""
        if self.norm_reduce_axes:
            raise NotImplementedError(
                "PermuteConsensus: norm_reduce_axes (tensor-parallel norms) not ported yet (ROADMAP.md "
                "Queue 1); the port runs exact and coded round-sets over static or scheduled graphs, "
                "with momentum, adaptive round budgets, trust reweighting and telemetry"
            )
        if self.path not in ("slab", "tree"):
            raise ValueError(f"unknown consensus path {self.path!r}")
        if self.algorithm not in ("drt", "classical"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if rounds < 1:
            raise ValueError(
                f"PermuteConsensus needs rounds >= 1, got {rounds}; skip the call entirely "
                "for a consensus-free step"
            )
        beta, tol = _control_knobs(self.momentum, self.round_tol)
        robust.validate_trust_knobs(self.trust_clip, self.trust_temp)
        K = self.topology.num_agents
        if self.schedule is not None:
            if not all(hasattr(self.schedule, a) for a in ("topology_at", "num_agents", "static")):
                raise TypeError(
                    f"schedule must be a dynamic.TopologySchedule, got {type(self.schedule).__name__}"
                )
            if isinstance(start_round, bool) or not isinstance(start_round, (int, np.integer)):
                raise TypeError(
                    "PermuteConsensus derives each round's exchanges on the host; start_round "
                    f"must be a Python int, got {type(start_round).__name__}"
                )
            if self.schedule.num_agents != K:
                raise ValueError(f"schedule K={self.schedule.num_agents} != topology K={K}")
        if exchange.size != K:
            raise ValueError(f"exchange has {exchange.size} ranks, the topology {K} agents")
        codec = None if self.codec is None else make_codec(self.codec)
        wire_codec = None if isinstance(codec, IdentityCodec) else codec
        if wire_codec is not None:
            if self.path == "slab":
                _wire_mode(wire_codec)  # refuses codecs without a slab path
            rng = _round_set_key(wire_codec, rng)
        call = self._call_slab if self.path == "slab" else self._call_tree
        with torch.no_grad():
            out, res, metrics = call(psi_local, exchange, codec_state, rng, rounds, wire_codec,
                                     int(start_round), beta, tol, obs)
        ret = (out,)
        if codec is not None:
            ret += (res if res is not None else codec_state if codec_state is not None else (),)
        if obs is not None:
            ret += (metrics,)
        return ret[0] if len(ret) == 1 else ret

    def _global_disagreement(self, exchange, x: torch.Tensor) -> torch.Tensor:
        """``mean_k ||x_k - x_bar||^2`` over the ranks from each rank's flat
        f32 ``x``: one psum of ``x`` and one of the local sum, so every rank
        reads the same bits."""
        K = self.topology.num_agents
        x_bar = exchange.psum(x) / K
        return exchange.psum((x - x_bar).square().sum()) / K

    def _row(self, exchange, x, ctl: _Control, r: int, *, col=None, d2s=None, w_all=None, res_sq=None,
             per_wire, n_ex: int, edges: float, idb: float) -> dict:
        """One rank's telemetry of round ``r`` (class docstring), with
        host floats where the value is known on the host; ``x`` the rank's
        flat f32 iterate after the round, ``d2s`` (n, L) its neighbours'
        distances, ``w_all`` its mixing column, ``res_sq`` its residual's
        squared norm; ``col``, ``d2s`` and ``w_all`` are ``None`` on a round
        without edges, which adds no momentum.  The distance summaries and
        the entropy wait for :meth:`_stack_rows`."""
        if isinstance(per_wire, float):  # in f32, as the reference divides
            ratio = float(np.float32(idb) / np.float32(max(per_wire, 1.0)))
        else:
            ratio = torch.full_like(per_wire, idb) / torch.clamp(per_wire, min=1.0)
        return dict(
            disagreement=self._global_disagreement(exchange, x),
            d2s=d2s,
            mask=None if col is None else col.mask,
            w_all=w_all,
            ef_residual=res_sq,
            wire=n_ex * per_wire,
            compression_ratio=ratio,
            edges=edges,
            effective_rounds=ctl.eff if ctl.tol is not None else float(r + 1),
            momentum_norm=None if col is None else ctl.mom_sq,
        )

    def _stack_rows(self, rows: list, L: int, device) -> ConsensusMetrics:
        """A rank's rows stacked (``None``: zeros).  The distance summaries
        and the column entropies of every round in one call each when every
        round exchanged over the same number of neighbours (a static
        graph), else round by round."""

        def stack(vals, shape=()):
            if all(v is None for v in vals):
                return torch.zeros(len(vals), *shape, dtype=torch.float32, device=device)
            if all(v is None or isinstance(v, float) for v in vals):  # a scalar known on the host
                return torch.tensor([0.0 if v is None else v for v in vals], dtype=torch.float32, device=device)
            zero = torch.zeros(shape, dtype=torch.float32, device=device)
            return torch.stack([zero if v is None else torch.as_tensor(v, dtype=torch.float32, device=device)
                                for v in vals])

        field = lambda name: [row[name] for row in rows]  # noqa: E731
        if all(row["w_all"] is not None for row in rows) and len({row["w_all"].shape for row in rows}) == 1:
            d2m, d2x = obs_metrics.neighbour_d2_summaries(torch.stack(field("d2s")), torch.stack(field("mask")))
            entropy = obs_metrics.column_entropy(torch.stack(field("w_all")))
        else:
            d2 = [(None, None) if row["w_all"] is None else obs_metrics.neighbour_d2_summaries(row["d2s"], row["mask"])
                  for row in rows]
            d2m, d2x = stack([d[0] for d in d2], (L,)), stack([d[1] for d in d2], (L,))
            entropy = stack([None if row["w_all"] is None else obs_metrics.column_entropy(row["w_all"])
                             for row in rows])
        wire = stack(field("wire"))
        return ConsensusMetrics(
            disagreement=stack(field("disagreement")),
            layer_d2_mean=d2m,
            layer_d2_max=d2x,
            mix_entropy=entropy,
            ef_residual=stack(field("ef_residual")),
            wire_send_bytes=wire,
            wire_recv_bytes=wire,
            compression_ratio=stack(field("compression_ratio")),
            edges=stack(field("edges")),
            effective_rounds=stack(field("effective_rounds")),
            momentum_norm=stack(field("momentum_norm")),
            suspicion=torch.zeros(len(rows), self.topology.num_agents, dtype=torch.float32, device=device),
            byzantine_weight_mass=torch.zeros(len(rows), dtype=torch.float32, device=device),
        )

    def _call_slab(self, psi_local, exchange, codec_state, rng, rounds, wire_codec, start_round, beta, tol, obs):
        """The slab round loop of one rank (module docstring).  Returns
        ``(tree, residual tree or None, metrics or None)``."""
        my = exchange.rank
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
        slots = layout.slot_table_on(device)
        ctl = _Control(beta, tol, slab, device, track=obs is not None)
        # DRT reads the exchanges' distances; telemetry reads them on a classical round too
        need_stats = self.algorithm == "drt" or obs is not None
        if obs is not None:
            idb = obs_metrics.slab_identity_bytes(layout)
            per_wire = None if stateful else obs_metrics.slab_static_wire_bytes(wire_codec, layout)
            rows = []

        def row(**kw):
            pw = per_wire
            if pw is None:  # top-k: the sent values of this round's wire
                pw = obs_metrics.slab_wire_send_bytes(wire_codec, layout, wire)[0]
            res_sq = None if res is None else res.square().sum()
            rows.append(self._row(exchange, slab[0], ctl, r, res_sq=res_sq, per_wire=pw, idb=idb,
                                  edges=plan.edges, **kw))

        for r in range(rounds):
            plan = self._plan(start_round + r, layout.num_layers, device)
            if wire_codec is not None and (plan.perms or stateful):
                key = prng.fold_in(prng.fold_in(rng, r), my)
                with scope(obs, "consensus.encode"):
                    wire, new_res = slab_encode_batched(wire_codec, layout, slab, res, key[None])
            else:
                wire, new_res = slab, res
            if not plan.perms:  # no edge anywhere: every iterate stays as it is
                res = new_res
                if obs is not None:
                    row(n_ex=0)
                continue
            if tol is not None:
                ctl.gate(self._global_disagreement(exchange, slab[0]))
            self_hat = slab if wire_codec is None else slab_decode(wire_codec, layout, wire)
            quant = isinstance(wire, SlabQuant)
            recvs, stats = [], []
            for perm in plan.perms:
                got = exchange.ppermute(tuple(wire) if quant else (wire,), perm)
                recv = slab_decode(wire_codec, layout, SlabQuant(*got) if quant else got[0])
                if need_stats:
                    stats.append(drt_dist_slots(self_hat[0], recv[0], slots))  # (L, 2)
                recvs.append(recv[0])
            stats = torch.stack(stats).unbind(2) if stats else (None, None)
            col = plan.cols[my]
            w_all = self._mix_weights(col, *stats)  # (1 + n, L)
            w_blocks = w_all.index_select(1, bl).T.contiguous()  # (n_blocks, 1 + n)
            # the combine takes the agent's full-precision slab, not its wire,
            # and reads every source where it lies
            mixed = slab_source_combine(w_blocks, [slab[0]] + recvs)[None]
            slab = ctl.finish(slab, mixed)
            res = None if res is None else ctl.keep(new_res, res)
            if obs is not None:
                row(col=col, d2s=stats[0], w_all=w_all, n_ex=len(plan.perms))
        with scope(obs, "consensus.unpack"):
            out = tree_map(lambda x: x[0], layout.unpack(slab, like=one))
            if res is not None:
                like = one if codec_state in (None, ()) else tree_map(lambda x: x[None], codec_state)
                res = tree_map(lambda x: x[0], layout.unpack(res, like=like, dtype=torch.float32))
        return out, res, None if obs is None else self._stack_rows(rows, layout.num_layers, device)

    def _call_tree(self, psi_local, exchange, codec_state, rng, rounds, wire_codec, start_round, beta, tol, obs):
        """The per-leaf round loop of one rank (the reference's
        ``_call_tree``): encode and decode the rank's own tree, receive each
        exchange's whole wire in one ``ppermute``, weigh each neighbour by
        the per-layer norms of ``self_hat - recv`` and ``recv``, combine the
        full-precision tree with the decoded neighbours layer by layer;
        control on each round's output tree.  Returns ``(tree, residual
        tree or None, metrics or None)``."""
        my = exchange.rank
        part = self.partition
        device = tree_leaves(psi_local)[0].device
        stateful = wire_codec is not None and wire_codec.stateful
        state = codec_state
        if stateful and state in (None, ()):
            state = wire_codec.init_state(psi_local)
        ctl = _Control(beta, tol, psi_local, device, track=obs is not None)
        if obs is not None:
            idb = float(IdentityCodec().wire_bytes(psi_local))
            per_wire = None if stateful else float((wire_codec or IdentityCodec()).wire_bytes(psi_local))
            rows = []

        def flat_f32(tree):
            return torch.cat([as_f32(x).reshape(-1) for x in tree_leaves(tree)])

        def row(**kw):
            pw = per_wire
            if pw is None:  # top-k: the sent values of this round's wire
                pw = obs_metrics.tree_wire_send_bytes(wire_codec, wire, psi_local)
            res_sq = sum(x.square().sum() for x in tree_leaves(state)) if stateful else None
            rows.append(self._row(exchange, flat_f32(psi_local), ctl, r, res_sq=res_sq, per_wire=pw, idb=idb,
                                  edges=plan.edges, **kw))

        for r in range(rounds):
            plan = self._plan(start_round + r, part.num_layers, device)
            if wire_codec is not None and (plan.perms or stateful):
                key = prng.fold_in(prng.fold_in(rng, r), my)
                wire, new_state = wire_codec.encode(psi_local, state, key)
                self_hat = wire_codec.decode(wire)
            else:
                wire = self_hat = psi_local
                new_state = state
            if not plan.perms:  # no edge anywhere: every iterate stays as it is
                state = new_state
                if obs is not None:
                    row(n_ex=0)
                continue
            if tol is not None:
                ctl.gate(self._global_disagreement(exchange, flat_f32(psi_local)))
            flat = _wire_tensors(wire)
            mine = [as_f32(x) for x in tree_leaves(self_hat)]
            recvs, d2s, n2s = [], [], []
            for perm in plan.perms:
                got = _wire_like(wire, exchange.ppermute(flat, perm))
                recv = got if wire_codec is None else wire_codec.decode(got)
                if self.algorithm == "drt" or obs is not None:  # one multi-tensor op a step, not one a leaf
                    diff = torch._foreach_sub(mine, [as_f32(x) for x in tree_leaves(recv)])
                    d2s.append(part.sq_norms(tree_like(recv, diff)))
                    if self.algorithm == "drt":
                        n2s.append(part.sq_norms(recv))
                recvs.append(recv)
            d2s = torch.stack(d2s) if d2s else None
            stats = (d2s, torch.stack(n2s)) if n2s else (None, None)
            col = plan.cols[my]
            w_all = self._mix_weights(col, *stats)  # (1 + n, L)
            out = part.scale_by_layer(w_all[0], psi_local)
            acc = tree_leaves(out)
            for recv, w in zip(recvs, w_all[1:]):
                torch._foreach_add_(acc, tree_leaves(part.scale_by_layer(w, recv)))
            psi_local = ctl.finish(psi_local, out)
            state = ctl.keep(new_state, state) if stateful else new_state
            if obs is not None:
                row(col=col, d2s=d2s, w_all=w_all, n_ex=len(plan.perms))
        return psi_local, state if stateful else None, None if obs is None else self._stack_rows(
            rows, part.num_layers, device)


def _wire_tensors(wire: Tree) -> tuple:
    """Every tensor of a per-leaf wire, in ``tree_items`` order (an int8
    leaf's values, then its scales): what one ``ppermute`` carries."""
    flat = []
    for _, leaf in tree_items(wire):
        flat.extend((leaf.q, leaf.s) if isinstance(leaf, QuantLeaf) else (leaf,))
    return tuple(flat)


def _wire_like(wire: Tree, tensors: tuple) -> Tree:
    """Inverse of :func:`_wire_tensors`: ``tensors`` in ``wire``'s tree."""
    it = iter(tensors)
    return tree_map(lambda x: QuantLeaf(next(it), next(it)) if isinstance(x, QuantLeaf) else next(it), wire)

