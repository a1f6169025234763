"""Decentralized trainer: local SGD steps + (DRT | classical) consensus.

Counterpart of ``repro.core.decentralized`` for the paper's training loop
(§IV.A): each agent runs local mini-batch steps on its own non-IID shard,
then the network performs ``consensus_steps`` combination rounds, exact or
through a wire codec (``TrainerConfig.codec``), on the dense slab, over
the graph's edge lists or on the per-leaf tree oracle
(``TrainerConfig.consensus_path``).

The agent axis is a leading K axis on every parameter leaf.  The local step
takes every agent's gradient in ONE backward pass: the loss function is
agent-batched (``loss_fn(params_K, batch_K) -> (K,)`` per-agent losses, e.g.
``resnet20_agent_losses``, which runs the K models as one grouped network),
the agents do not interact, so the gradient of the summed losses is each
agent's own gradient.  Consensus runs under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.comm import prng
from repro_torch.comm.codec import init_comm_state, make_codec
from repro_torch.core.consensus import Algorithm, gather_consensus_rounds
from repro_torch.core.drt import DRTConfig
from repro_torch.core.dynamic import edge_stacks_from_topology, max_in_degree_from_topology
from repro_torch.core.packing import SlabLayout, build_slab_layout
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_leaves, tree_map

Tree = Any
AgentLossFn = Callable[[Tree, Any], torch.Tensor]  # (params_K, batch_K) -> (K,)


class DecentralizedState(NamedTuple):
    params: Tree  # leading agent axis K on every leaf
    opt_state: Tree
    step: int  # local steps taken (the reference's ``state.step``)
    comm: Tree = ()  # per-agent codec state: top-k's f32 residual tree, else ()


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The ported subset of the reference's ``TrainerConfig`` (static
    topology, no control or faults; those options are not ported yet).
    ``codec``: ``None`` for the exact exchange, or a wire codec name
    (``identity``, ``bf16``, ``f16``, ``int8``, ``topk[:frac]``).
    ``consensus_path``: ``"slab"`` runs every round on the dense (K, D)
    slab, ``"edge"`` the sparse O(|E| D) edge-list rounds over the graph's
    edges, ``"tree"`` the per-leaf oracle (plain PyTorch, no kernel)."""

    algorithm: Algorithm = "drt"
    consensus_steps: int = 3
    drt: DRTConfig = DRTConfig()
    same_init: bool = True  # all agents start from identical parameters
    codec: "str | None" = None
    consensus_path: str = "slab"

    def __post_init__(self):
        if self.algorithm not in ("drt", "classical"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.consensus_path not in ("slab", "edge", "tree"):
            raise ValueError(f"unknown consensus_path {self.consensus_path!r}")
        if self.consensus_steps < 0:
            raise ValueError(f"consensus_steps must be >= 0, got {self.consensus_steps}")
        make_codec(self.codec)  # an unknown name fails here


class DecentralizedTrainer:
    """Couples an agent-batched loss, an optimizer, a topology and a
    consensus rule, on one device (CUDA unless the caller says otherwise)."""

    def __init__(
        self,
        loss_fn: AgentLossFn,
        init_fn: Callable[[torch.Generator], Tree],
        optimizer: Optimizer,
        topology: Topology,
        cfg: TrainerConfig = TrainerConfig(),
        device: "torch.device | str | None" = None,
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.optimizer = optimizer
        self.topology = topology
        self.cfg = cfg
        self.codec = None if cfg.codec is None else make_codec(cfg.codec)
        self.K = topology.num_agents
        self._C = torch.as_tensor(topology.c_matrix(), dtype=torch.float32, device=self.device)
        self._metropolis = torch.as_tensor(
            topology.metropolis(), dtype=torch.float32, device=self.device
        )
        self._partition: LayerPartition | None = None
        self._layout: SlabLayout | None = None
        self._edges = None
        if cfg.consensus_path == "edge" and cfg.consensus_steps > 0:
            # the static graph's edge lists for one round-set and its CSR
            # bound, built once on the trainer's device
            self._edges = dict(
                edges=edge_stacks_from_topology(topology, cfg.consensus_steps, self.device),
                max_in_degree=max_in_degree_from_topology(topology),
            )

    # -- initialization -------------------------------------------------------

    def init(self, generator: torch.Generator) -> DecentralizedState:
        """Fresh parameters from ``init_fn(generator)`` (one draw shared by
        every agent when ``same_init``, else one draw per agent)."""
        if self.cfg.same_init:
            p0 = self.init_fn(generator)
            params = tree_map(lambda x: x.unsqueeze(0).repeat(self.K, *([1] * x.dim())), p0)
        else:
            draws = [self.init_fn(generator) for _ in range(self.K)]
            params = tree_map(lambda *xs: torch.stack(xs), *draws)
        return self.state_from_params(params)

    def state_from_params(self, params_K: Tree) -> DecentralizedState:
        """A step-0 state (fresh optimizer state, zero codec state) around
        given agent-stacked parameters, moved to the trainer's device: e.g.
        weights carried over from the reference through
        ``repro_torch.bridge``."""
        params_K = tree_map(lambda x: x.to(self.device), params_K)
        self.build_partition(params_K)
        return DecentralizedState(
            params_K, self.optimizer.init(params_K), 0, init_comm_state(self.codec, params_K)
        )

    @property
    def partition(self) -> LayerPartition:
        if self._partition is None:
            raise RuntimeError("call init() first")
        return self._partition

    def build_partition(self, params_K) -> LayerPartition:
        template = agent_template(params_K)
        self._partition = LayerPartition.build(template)
        self._layout = build_slab_layout(self._partition, template)
        return self._partition

    # -- steps ----------------------------------------------------------------

    def local_step(self, state: DecentralizedState, batch_K):
        """One local step per agent (eq. 3a / first line of (11))."""
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        losses = self.loss_fn(params, batch_K)
        leaves = tree_leaves(params)
        # leaves the loss never reads (stage 1's zero ``proj``) get zero grads
        grads_flat = torch.autograd.grad(losses.sum(), leaves, allow_unused=True)
        grads = _unflatten_like(
            params,
            [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads_flat)],
        )
        with torch.no_grad():
            new_params, new_opt = self.optimizer.update(
                grads, state.opt_state, state.params, state.step
            )
        return (
            DecentralizedState(new_params, new_opt, state.step + 1, state.comm),
            {"loss": losses.detach().mean()},
        )

    def consensus(self, state: DecentralizedState, obs: "ObsConfig | None" = None, rng=None):
        """``consensus_steps`` combination rounds (eq. 3b / second line of
        (11)): DRT recomputes its mixing matrices every round, classical
        diffusion reuses the static Metropolis matrix.  With a codec the
        exchange is coded, the top-k residual rides in ``state.comm``, and
        ``rng`` (two uint32 key words) defaults to the reference's
        step-derived key ``fold_in(key(0), state.step)``.  Returns ``(state,
        A_last)``, or ``(state, A_last, metrics)`` with ``obs``."""
        if self.codec is None:
            out = self._rounds(state, obs)
            return (DecentralizedState(out[0], state.opt_state, state.step, state.comm), *out[1:])
        if rng is None:
            rng = prng.fold_in(prng.key(0), state.step)
        params, A, comm, *metrics = self._rounds(
            state, obs, codec=self.codec, codec_state=state.comm, rng=rng
        )
        return (DecentralizedState(params, state.opt_state, state.step, comm), A, *metrics)

    def _rounds(self, state: DecentralizedState, obs, **codec_kw):
        return gather_consensus_rounds(
            self.partition,
            state.params,
            self._C,
            self.cfg.drt,
            rounds=self.cfg.consensus_steps,
            algorithm=self.cfg.algorithm,
            metropolis=self._metropolis,
            layout=self._layout,
            obs=obs,
            path=self.cfg.consensus_path,
            **(self._edges or {}),
            **codec_kw,
        )

    def disagreement(self, params_K) -> torch.Tensor:
        """sum_k || w_k - w_bar ||^2."""
        return sum(
            (x.float() - x.float().mean(0, keepdim=True)).square().sum()
            for x in tree_leaves(params_K)
        )

    def epoch(self, state: DecentralizedState, batches_K):
        """Local steps over an epoch of per-agent batches, then one
        consensus round-set.

        ``batches_K``: dict of arrays (numpy or tensors) with leading
        (n_batches, K, ...) axes.  Returns ``(state, metrics)``; metrics hold
        ``loss`` (mean over the epoch's steps), ``disagreement`` (``mean_k
        ||x_k - x_bar||^2`` after the last round, from the consensus
        telemetry), ``effective_rounds``, and the host seconds of the local
        steps and of the consensus (each measured after a device sync)."""
        batches = {k: torch.as_tensor(v).to(self.device) for k, v in batches_K.items()}
        n_batches = next(iter(batches.values())).shape[0]
        synchronize(self.device)
        t0 = time.perf_counter()
        losses = []
        for i in range(n_batches):
            state, m = self.local_step(state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
        synchronize(self.device)
        t1 = time.perf_counter()
        if self.cfg.consensus_steps > 0:
            state, _, cm = self.consensus(state, obs=ObsConfig())
            dis, eff = cm.disagreement[-1], cm.effective_rounds[-1]
        else:
            dis = self.disagreement(state.params) / self.K
            eff = torch.zeros((), device=self.device)
        synchronize(self.device)
        t2 = time.perf_counter()
        return state, {
            "loss": torch.stack(losses).mean(),
            "disagreement": dis,
            "effective_rounds": eff,
            "local_seconds": t1 - t0,
            "consensus_seconds": t2 - t1,
        }


def _unflatten_like(tree: Tree, flat) -> Tree:
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)
