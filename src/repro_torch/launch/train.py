"""Decentralized LM training: the train step and its CLI.

Counterpart of ``repro/launch/train.py`` on the gather engine.  A step is
one local SGD step per agent on its own token batch, then
``consensus_rounds`` DRT (or classical) combination rounds over the K
agents (:mod:`repro_torch.core.consensus`, through the trainer's consensus
of :mod:`repro_torch.core.decentralized`): exact or coded
(``codec`` / ``tcfg.codec``; ``exchange_dtype`` is the deprecated spelling
of a cast codec), on the slab, edge or tree path, over a static topology or
a schedule, with heavy-ball momentum, an adaptive round budget, faults,
trust reweighting, a robust combine and telemetry, all as
:class:`~repro_torch.core.decentralized.TrainerConfig` sets them.  The key
flow is the reference's: a step's key is split into a local and a
consensus key only when there is a codec (``repro_torch.comm.prng``, so an
int8 wire equals the reference's bit for bit).

Where the reference vmaps ``value_and_grad`` of the loss over the agent
axis, the port loops over the K agents, each on views of the K-stacked
parameters, its gradient written into one K-stacked gradient tree.  The
update is the optimizer's in-place ``update_`` (the reference donates its
state to XLA), and the gradients are dropped before the consensus, so at
four full-width qwen3-4b agents the step holds parameters, moments and
gradients (3 x 15.7 GB), then parameters, moments and the consensus's two
(K, D) slabs (4 x 15.7 GB).  The step therefore CONSUMES its state: the
parameters and moments of the state passed in are updated in place.

The ``dense`` family trains on either device: on CUDA its attention runs
the ``flash_attention`` forward and backward kernels, the consensus its
kernels.  The ``ssm`` family raises (Mamba training, ROADMAP.md, Queue 1
#5b), as do the families the port does not run (the model zoo) and the
reference's ``consensus_impl="permute"`` (a mesh, one agent a device:
ROADMAP.md, Queue 1 #9).

Run: ``python -m repro_torch.launch.train --device cpu --steps 6`` (CUDA
unless ``--device`` says otherwise; raises without a GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs as port_obs
from repro_torch.comm import prng
from repro_torch.comm.codec import CastCodec, init_comm_state, make_codec
from repro_torch.core.decentralized import DecentralizedState, DecentralizedTrainer, TrainerConfig
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.registry import ModelBundle
from repro_torch.obs.metrics import ObsConfig, stack_metrics
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.pytree import LayerPartition, agent_template, container_map, tree_leaves, tree_map

Tree = Any


class TrainState(NamedTuple):
    params: Tree  # leading agent axis K on every leaf
    opt_state: Tree
    step: int
    comm: Tree = ()  # per-agent wire-codec state (top-k's error-feedback residual)


def _check_trainable(bundle: ModelBundle) -> None:
    family = bundle.cfg.family
    if family == "ssm":
        raise NotImplementedError(
            f"{bundle.cfg.name}: training the ssm family needs a backward for the selective_scan kernel "
            "(ROADMAP.md, Queue 1 #5b: Mamba training)"
        )
    if family != "dense":
        raise NotImplementedError(
            f"{bundle.cfg.name}: the {family!r} family is not ported yet (ROADMAP.md, Queue 1: the model zoo)"
        )


def init_train_state(bundle: ModelBundle, optimizer: Optimizer, generator: torch.Generator,
                     codec=None) -> TrainState:
    """Step-0 state on the generator's device: one draw of
    ``bundle.init(generator)`` copied to every one of ``cfg.num_agents``
    agents, the optimizer's fresh state and the codec's (top-k: a zero
    residual tree, else ``()``)."""
    K = bundle.cfg.num_agents
    p1 = bundle.init(generator)
    params = tree_map(lambda x: x.unsqueeze(0).repeat(K, *([1] * x.dim())), p1)
    del p1
    return TrainState(params, optimizer.init(params), 0, init_comm_state(codec, params))


def state_to(state: TrainState, device) -> TrainState:
    """``state`` with every tensor on ``device`` (a tensor already there is
    kept, not copied)."""
    return TrainState(*(container_map(lambda x: x.to(device), part) for part in state[:2]), state.step,
                      container_map(lambda x: x.to(device), state.comm))


def build_partition(params_K: Tree) -> LayerPartition:
    """The DRT layer partition of an agent-stacked parameter tree (the
    reference builds it from an abstract init; the port from the state)."""
    return LayerPartition.build(agent_template(params_K))


def _exchange_codec(exchange_dtype) -> CastCodec:
    warnings.warn("exchange_dtype is deprecated; pass codec='bf16' (or a WireCodec) instead",
                  DeprecationWarning, stacklevel=3)
    if not isinstance(exchange_dtype, torch.dtype):
        raise TypeError(f"exchange_dtype must be a torch dtype, got {exchange_dtype!r}")
    return CastCodec(dtype=exchange_dtype, name=str(exchange_dtype).removeprefix("torch."))


def make_train_step(
    bundle: ModelBundle,
    topology: Topology,
    optimizer: Optimizer,
    tcfg: TrainerConfig = TrainerConfig(),
    consensus_rounds: int = 1,
    consensus_impl: str = "gather",
    exchange_dtype=None,
    codec=None,
    obs: "ObsConfig | None" = None,
    device: "torch.device | str | None" = None,
):
    """Returns ``step(state, batch_K, key) -> (state, metrics)`` on
    ``device`` (CUDA unless given): ``batch_K`` holds ``"tokens"`` (K, B,
    S + 1) (and optionally ``"mask"``), ``key`` is a step key
    (``prng.key(i)``, two uint32 words).  ``metrics["loss"]`` is the mean
    of the K agents' losses; with ``obs`` ``metrics["consensus"]`` is the
    round-set's ``ConsensusMetrics`` (leading ``(rounds,)`` axis).  The
    step consumes ``state`` (module docstring).  ``tcfg.consensus_steps``
    is not read: ``consensus_rounds`` (or ``tcfg.rounds_policy``) is the
    round budget."""
    _check_trainable(bundle)
    if consensus_impl == "permute":
        raise NotImplementedError(
            "consensus_impl='permute' runs one agent a device over a mesh: ROADMAP.md, Queue 1 #9 "
            "(multiple GPUs and tensor-parallel norms); use consensus_impl='gather'"
        )
    if consensus_impl != "gather":
        raise ValueError(f"unknown consensus_impl {consensus_impl!r}")
    K = bundle.cfg.num_agents
    if topology.num_agents != K:
        raise ValueError(f"topology K={topology.num_agents} != cfg K={K}")
    if codec is None:
        codec = tcfg.codec
    wire_codec = None if codec is None else make_codec(codec)
    if wire_codec is not None and exchange_dtype is not None:
        raise ValueError("pass either codec or (deprecated) exchange_dtype, not both")
    effective = _exchange_codec(exchange_dtype) if exchange_dtype is not None else wire_codec
    trainer = DecentralizedTrainer(
        None, bundle.init, optimizer, topology,
        dataclasses.replace(tcfg, codec=effective, consensus_steps=consensus_rounds), device,
    )
    if trainer.rounds < 1:
        raise ValueError(f"make_train_step needs consensus_rounds >= 1, got {trainer.rounds}")
    dev = trainer.device
    built = []  # the layer partition and slab layout, from the first state's parameters

    def local_grads(state: TrainState, batch, keys):
        """Each agent's loss and gradient, into one K-stacked gradient tree."""
        grads = tree_map(torch.empty_like, state.params)
        grad_leaves = tree_leaves(grads)
        losses = []
        for k in range(K):
            p_k = tree_map(lambda x: x[k].detach().requires_grad_(True), state.params)
            leaves = tree_leaves(p_k)
            loss = bundle.loss(p_k, {name: x[k] for name, x in batch.items()}, keys[k])
            for dst, g in zip(grad_leaves, torch.autograd.grad(loss, leaves, allow_unused=True)):
                # a leaf the loss never reads gets a zero gradient
                dst[k].zero_() if g is None else dst[k].copy_(g)
            losses.append(loss.detach())
        return torch.stack(losses), grads

    def step(state: TrainState, batch_K, key):
        if wire_codec is None:
            lkey = ckey = np.asarray(key, np.uint32)  # the pre-codec key flow
        else:
            lkey, ckey = prng.split(key, 2)
        keys = prng.split(lkey, K)
        batch = {name: torch.as_tensor(x).to(dev) for name, x in batch_K.items()}
        if not built:
            built.append(trainer.build_partition(state.params))
        losses, grads = local_grads(state, batch, keys)
        with torch.no_grad():
            optimizer.update_(grads, state.opt_state, state.params, state.step)
        del grads
        local = DecentralizedState(state.params, state.opt_state, state.step, state.comm)
        out = trainer.consensus(local, obs=obs, rng=ckey if effective is not None else None)
        new = out[0]
        metrics = {"loss": losses.mean()}
        if obs is not None:
            metrics["consensus"] = out[2]
        return TrainState(new.params, state.opt_state, state.step + 1, new.comm), metrics

    return step


def make_train_many_steps(
    bundle: ModelBundle,
    topology: Topology,
    optimizer: Optimizer,
    tcfg: TrainerConfig = TrainerConfig(),
    consensus_rounds: int = 1,
    consensus_impl: str = "gather",
    codec=None,
    obs: "ObsConfig | None" = None,
    device: "torch.device | str | None" = None,
):
    """A chunk of train steps as one call: ``many(state, batches_K, keys)
    -> (state, {"loss": (n,)})`` where ``batches_K`` leaves carry a leading
    ``(n, K, ...)`` axis and ``keys`` is the ``(n, 2)`` stack of the
    per-step keys a loop of single steps would pass.  A plain loop of
    :func:`make_train_step`'s step, so the result is bit for bit that of
    ``n`` single steps (the consensus key and a schedule's rounds derive
    from the carried ``state.step``); the reference's one scanned, donated
    dispatch has no counterpart here.  With ``obs`` the dict gains
    ``"consensus"``, the per-step records with leading ``(n, rounds)``
    axes."""
    step = make_train_step(bundle, topology, optimizer, tcfg, consensus_rounds=consensus_rounds,
                           consensus_impl=consensus_impl, codec=codec, obs=obs, device=device)

    def many(state: TrainState, batches_K, keys):
        losses, per_step = [], []
        for i in range(len(keys)):
            state, metrics = step(state, {name: x[i] for name, x in batches_K.items()}, keys[i])
            losses.append(metrics["loss"])
            if obs is not None:
                per_step.append(metrics["consensus"])
        out = {"loss": torch.stack(losses)}
        if obs is not None:
            out["consensus"] = stack_metrics(per_step)
        return state, out

    return many


# ---------------------------------------------------------------------------
# CLI (the reference's flags, plus --device)
# ---------------------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="decentralized LM training")
    ap.add_argument("--arch", default="qwen3-8b-smoke")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--algorithm", default="drt", choices=["drt", "classical"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--consensus-rounds", type=int, default=1)
    ap.add_argument("--consensus-momentum", type=float, default=0.0,
                    help="heavy-ball momentum beta on the combination rounds (0.0: none)")
    ap.add_argument("--rounds-policy", default=None,
                    help="per-step round budget: 'fixed:<n>' or 'adaptive:<tol>:<max>'; overrides "
                         "--consensus-rounds")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="train steps per make_train_many_steps call (bit for bit per-step calls)")
    ap.add_argument("--consensus-path", default="slab", choices=["slab", "tree", "edge"],
                    help="'slab' dense slab rounds (default), 'edge' sparse edge-list rounds, 'tree' the "
                         "per-leaf oracle")
    ap.add_argument("--codec", default=None,
                    help="wire codec: identity|bf16|f16|int8|topk[:frac[:sample]] (default: exact f32)")
    ap.add_argument("--schedule", default=None,
                    help="time-varying graph: a topology name, 'periodic:<a>,<b>[@n]', 'gossip[:p]' or "
                         "'onepeer' (default: the static --topology graph)")
    ap.add_argument("--agent-dropout", type=float, default=0.0,
                    help="per-round probability an agent drops all its edges")
    ap.add_argument("--edge-dropout", type=float, default=0.0,
                    help="per-round probability each surviving edge drops")
    ap.add_argument("--schedule-seed", type=int, default=0, help="seed for gossip draws and churn")
    ap.add_argument("--byzantine", type=float, default=0.0,
                    help="Byzantine agent fraction (needs --fault-model; 0.0 = off)")
    ap.add_argument("--fault-model", default=None,
                    help="sign_flip | gauss:<sigma> | cgauss:<sigma> | scale:<c> | constant[:<v>]")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for Byzantine membership, attacks and wire-fault tables")
    ap.add_argument("--drop", type=float, default=0.0, help="per-round per-edge message-drop probability")
    ap.add_argument("--stale", type=float, default=0.0,
                    help="per-round probability an agent's neighbours receive its previous iterate")
    ap.add_argument("--trust-clip", type=float, default=None, help="cap on any neighbour's mixing weight")
    ap.add_argument("--trust-temp", type=float, default=None, help="temperature on the off-diagonal weights")
    ap.add_argument("--combine", default="drt", help="'drt' (default) | 'trimmed:<f>' | 'median'")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="turn on consensus telemetry and append one JSON record per round to this file; "
                         "a summary table prints at the end")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the run (trace.json) here and name the "
                         "consensus phases; implies telemetry on")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    if args.consensus_rounds < 1:
        ap.error(f"--consensus-rounds must be >= 1 (got {args.consensus_rounds}); the consensus engines "
                 "refuse a zero-round exchange rather than silently no-op")
    if not 0.0 <= args.consensus_momentum < 1.0:
        ap.error(f"--consensus-momentum must be in [0, 1) (got {args.consensus_momentum}); the heavy-ball "
                 "recurrence diverges at beta >= 1")
    return args


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"state", "losses" (per step), "seconds",
    "tokens_per_s", "peak_memory_bytes" (CUDA, else None)}``."""
    from repro_torch.core.dynamic import make_schedule
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.models.registry import get_bundle
    from repro_torch.optim.optimizers import momentum

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the DRT Gram cancels badly under TF32
    bundle = get_bundle(args.arch, num_agents=args.agents)
    topo = make_topology(args.topology, args.agents)
    opt = momentum(args.lr, 0.9)
    schedule = make_schedule(
        args.schedule if args.schedule is not None
        else (args.topology if (args.agent_dropout or args.edge_dropout) else None),
        args.agents, agent_drop=args.agent_dropout, edge_drop=args.edge_dropout, seed=args.schedule_seed,
    )
    tcfg = TrainerConfig(
        algorithm=args.algorithm, codec=args.codec, schedule=schedule, consensus_path=args.consensus_path,
        consensus_momentum=args.consensus_momentum, rounds_policy=args.rounds_policy,
        byzantine=args.byzantine, fault_model=args.fault_model, fault_seed=args.fault_seed, stale=args.stale,
        drop=args.drop, trust_clip=args.trust_clip, trust_temp=args.trust_temp, combine=args.combine,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # weights drawn on the CPU, then moved: the same start on every device
    state = state_to(init_train_state(bundle, opt, torch.Generator().manual_seed(0), codec=args.codec), device)
    stream = SyntheticTokenStream(TokenStreamConfig(vocab=bundle.cfg.vocab, seq_len=args.seq))
    obs = ObsConfig(annotate=args.profile_dir is not None) if (args.metrics_jsonl or args.profile_dir) else None
    sink = port_obs.JsonlSink(args.metrics_jsonl) if args.metrics_jsonl else None
    thru = port_obs.Throughput()
    tokens_per_step = args.agents * args.batch * args.seq
    print(f"device {device} arch {args.arch} agents {args.agents} params/agent "
          f"{sum(x[0].numel() for x in tree_leaves(state.params)):,} (weights drawn on the CPU, seed 0)", flush=True)
    all_losses = []

    def emit(cm, step_idx: int) -> None:
        if sink is not None and cm is not None:
            for rec in port_obs.consensus_records(cm, step=step_idx):
                sink.write(rec)

    def batch_at(i):
        return {"tokens": torch.from_numpy(stream.agent_batches(args.batch, args.agents, step=i))}

    # close the sink even when the loop raises: line-buffered JSONL keeps
    # every completed round's record
    t_start = time.perf_counter()
    try:
        with port_obs.trace(args.profile_dir):
            if args.steps_per_call > 1:
                many = make_train_many_steps(bundle, topo, opt, tcfg, consensus_rounds=args.consensus_rounds,
                                             obs=obs, device=device)
                i = 0
                while i < args.steps:
                    n = min(args.steps_per_call, args.steps - i)
                    tokens = torch.stack([batch_at(j)["tokens"] for j in range(i, i + n)])  # (n, K, B, S+1)
                    keys = np.stack([prng.key(j) for j in range(i, i + n)])
                    with port_obs.annotation(f"train.chunk[{i}:{i + n}]"):
                        state, metrics = many(state, {"tokens": tokens}, keys)
                        losses = metrics["loss"].cpu().numpy()  # syncs the chunk
                    all_losses.extend(float(x) for x in losses)
                    rate = thru.update(n, n * tokens_per_step)
                    print(f"steps {i:4d}..{i + n - 1:4d}  loss mean {float(losses.mean()):.4f} "
                          f"last {float(losses[-1]):.4f}  {rate.steps_per_s:7.2f} steps/s  "
                          f"{rate.tokens_per_s:9.0f} tok/s  ({n} steps/call)")
                    if obs is not None:
                        cm = metrics["consensus"]
                        for j in range(n):
                            emit(type(cm)(*(x[j] for x in cm)), i + j)
                    i += n
            else:
                step = make_train_step(bundle, topo, opt, tcfg, consensus_rounds=args.consensus_rounds, obs=obs,
                                       device=device)
                for i in range(args.steps):
                    with port_obs.annotation(f"train.step[{i}]"):
                        state, metrics = step(state, batch_at(i), prng.key(i))
                        loss = float(metrics["loss"])  # syncs the step
                    all_losses.append(loss)
                    rate = thru.update(1, tokens_per_step)
                    emit(metrics.get("consensus"), i)
                    if i % 10 == 0 or i == args.steps - 1:
                        print(f"step {i:4d}  loss {loss:.4f}  {rate.steps_per_s:7.2f} steps/s  "
                              f"{rate.tokens_per_s:9.0f} tok/s")
    finally:
        if sink is not None:
            sink.close()
    synchronize(device)
    seconds = time.perf_counter() - t_start
    life = thru.lifetime()
    print(f"total: {life.steps} steps in {life.seconds:.1f}s  {life.steps_per_s:.2f} steps/s  "
          f"{life.tokens_per_s:.0f} tok/s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if peak is not None:
        print(f"peak device memory {peak / 1e9:.2f} GB")
    if sink is not None:
        print(port_obs.format_summary(port_obs.summarize(port_obs.read_jsonl(args.metrics_jsonl))))
    if args.ckpt_dir:
        from repro_torch.ckpt import save_train_state

        print(f"saved {save_train_state(args.ckpt_dir, state)}")
    return {"state": state, "losses": all_losses, "seconds": seconds, "tokens_per_s": life.tokens_per_s,
            "peak_memory_bytes": peak}


if __name__ == "__main__":
    main()
