"""The paper's experiment (§IV) on the port: K agents train ResNet-20 on
non-IID shards of the CIFAR-like task; after each local epoch the network
runs ``consensus_steps`` exact DRT (or classical) rounds.

Counterpart of ``examples/decentralized_cifar.py`` and
``benchmarks/paper_experiment.py``, with the same flags; the defaults are
the paper's configuration (``configs/resnet20_cifar.py`` ``PAPER``): K=16,
width 16, 32x32 images, batch 128, 5-8 classes and 1500-2000 samples per
agent, 3 consensus steps, N = 2K, momentum SGD (lr 0.05, beta 0.9).
``--codec`` compresses the consensus exchange (``int8``, ``bf16``, ``f16``,
``topk[:frac]``; default: the exact f32 exchange) and prints the wire's
compression ratio.  ``--consensus-path edge`` runs the sparse edge-list
rounds, ``tree`` the per-leaf oracle (default ``slab``, the dense rounds).
``--schedule`` makes the graph time-varying (``periodic:ring,hypercube``,
``gossip:0.3``, ``onepeer``, ...), ``--agent-dropout`` / ``--edge-dropout``
add churn (over the schedule, or over each static topology), and
``--consensus-momentum`` / ``--rounds-policy`` (``adaptive:<tol>:<max>``)
set the round control, with the reference train CLI's meanings.

Runs on CUDA unless ``--device`` says otherwise; the combine goes through
the ``slab_combine`` kernel there (a coded round through
``slab_encode_combine``, an edge round through
``slab_edge_encode_combine``).  Matmuls stay in full float32 (the DRT
distances come from a Gram matrix and cancel badly under TF32); cuDNN
convolutions use TF32, PyTorch's default.

Run:  PYTHONPATH=src python -m repro_torch.experiment --epochs 8
"""
from __future__ import annotations

import argparse
import csv
import time

import torch

from repro_torch.comm.accounting import compression_ratio
from repro_torch.comm.codec import make_codec
from repro_torch.configs.resnet20_cifar import PAPER
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.dynamic import make_round_policy, make_schedule
from repro_torch.core.topology import PAPER_ER_SEED, make_topology
from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
from repro_torch.device import resolve_device
from repro_torch.models.resnet import init_resnet20, resnet20_accuracy, resnet20_agent_losses
from repro_torch.optim.optimizers import adamw, momentum
from repro_torch.utils.pytree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agents", type=int, default=PAPER.num_agents)
    ap.add_argument("--width", type=int, default=PAPER.width)
    ap.add_argument("--image-size", type=int, default=PAPER.image_size)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=PAPER.batch_size)
    ap.add_argument("--lr", type=float, default=PAPER.lr)
    ap.add_argument("--optimizer", default="momentum", choices=["adam", "momentum"])
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--min-samples", type=int, default=PAPER.min_samples_per_agent)
    ap.add_argument("--max-samples", type=int, default=PAPER.max_samples_per_agent)
    ap.add_argument("--topologies", default="ring,erdos_renyi,hypercube")
    ap.add_argument(
        "--codec", default=None,
        help="wire codec for the consensus exchange: identity|bf16|f16|int8|topk[:frac] "
             "(default: exact f32 exchange)",
    )
    ap.add_argument(
        "--consensus-path", default="slab", choices=["slab", "edge", "tree"],
        help="slab: dense (K, D) slab rounds; edge: sparse O(|E| D) edge-list rounds; "
             "tree: the per-leaf oracle (no kernel)",
    )
    ap.add_argument(
        "--schedule", default=None,
        help="time-varying communication graph: a topology name, 'periodic:<a>,<b>[@n]', "
             "'gossip[:p]' or 'onepeer' (default: each static --topologies graph)",
    )
    ap.add_argument(
        "--agent-dropout", type=float, default=0.0,
        help="per-round probability an agent drops all its edges (it keeps its own "
             "iterate); wraps the schedule, or each static topology, in churn",
    )
    ap.add_argument(
        "--edge-dropout", type=float, default=0.0,
        help="per-round probability each surviving edge drops (symmetric)",
    )
    ap.add_argument("--schedule-seed", type=int, default=0,
                    help="seed for gossip draws and churn failures")
    ap.add_argument(
        "--consensus-momentum", type=float, default=0.0,
        help="heavy-ball momentum beta on the combination rounds: "
             "x_{t+1} = mix(x_t) + beta (x_t - x_{t-1}); 0.0 (default) is off",
    )
    ap.add_argument(
        "--rounds-policy", default=None,
        help="per-round-set budget: 'fixed:<n>' or 'adaptive:<tol>:<max>' (a round runs "
             "while the disagreement exceeds tol; later rounds keep the iterate); "
             "overrides the paper's 3 consensus steps",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out-csv", default=None)
    args = ap.parse_args(argv)
    if args.codec is not None:
        try:
            make_codec(args.codec)
        except ValueError as e:
            ap.error(f"--codec {args.codec}: {e}")
    if not 0.0 <= args.consensus_momentum < 1.0:
        ap.error(f"--consensus-momentum must be in [0, 1), got {args.consensus_momentum}")
    for flag, value, make in (("--schedule", args.schedule, lambda v: make_schedule(v, args.agents)),
                              ("--rounds-policy", args.rounds_policy, make_round_policy)):
        if value is not None:
            try:
                make(value)
            except (ValueError, KeyError, TypeError) as e:
                ap.error(f"{flag} {value}: {e}")
    return args


def configure_precision(conv_tf32: bool) -> dict:
    """Set both TF32 switches explicitly and return them: cuDNN convs per
    ``conv_tf32``, matmuls always full float32."""
    torch.backends.cudnn.allow_tf32 = bool(conv_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def topology_for(name: str, K: int):
    if name == "erdos_renyi":
        return make_topology(name, K, p=0.1, seed=PAPER_ER_SEED)
    return make_topology(name, K)


def make_data(args):
    """Per-agent shards (the paper's non-IID partition) and a test set, as
    numpy arrays in NHWC."""
    data = CifarLike(
        CifarLikeConfig(image_size=args.image_size, noise=args.noise, max_shift=0)
    )
    shards = data.paper_partition(
        num_agents=args.agents, min_samples=args.min_samples,
        max_samples=args.max_samples, seed=1,
    )
    return shards, data.test_set(512)


def schedule_for(args, topology):
    """The run's schedule: ``--schedule``, else the static ``topology``
    when churn is asked, wrapped in churn by ``--agent-dropout`` /
    ``--edge-dropout``; ``None`` keeps the static topology."""
    base = args.schedule
    if base is None and (args.agent_dropout or args.edge_dropout):
        base = topology
    return make_schedule(base, args.agents, agent_drop=args.agent_dropout,
                         edge_drop=args.edge_dropout, seed=args.schedule_seed)


def build_trainer(args, topology, algorithm: str, device) -> DecentralizedTrainer:
    opt = adamw(args.lr) if args.optimizer == "adam" else momentum(args.lr, PAPER.momentum)
    return DecentralizedTrainer(
        resnet20_agent_losses,
        lambda g: init_resnet20(g, width=args.width, device=device),
        opt,
        topology,
        TrainerConfig(algorithm=algorithm, consensus_steps=PAPER.consensus_steps,
                      codec=args.codec, consensus_path=args.consensus_path,
                      schedule=schedule_for(args, topology),
                      consensus_momentum=args.consensus_momentum,
                      rounds_policy=args.rounds_policy),
        device=device,
    )


def run_experiment(args, topology_name: str, algorithm: str, shards, test, device=None):
    """Train one (topology, algorithm) pair for ``args.epochs`` epochs.
    Returns ``(lambda2, history)``, one dict per epoch."""
    device = resolve_device(device)
    topo = topology_for(topology_name, args.agents)
    tr = build_trainer(args, topo, algorithm, device)
    st = tr.init(torch.Generator().manual_seed(0))
    test_b = {"images": torch.as_tensor(test[0], device=device),
              "labels": torch.as_tensor(test[1], device=device)}
    n_ev = min(len(test[1]), len(shards[0][1]))
    train_b = {"images": torch.as_tensor(shards[0][0][:n_ev], device=device),
               "labels": torch.as_tensor(shards[0][1][:n_ev], device=device)}
    history = []
    for e in range(args.epochs):
        st, m = tr.epoch(st, agent_minibatches(shards, batch_size=args.batch, epoch_seed=e))
        # evaluate agent 0 (all agents are statistically equivalent)
        with torch.no_grad():
            p0 = tree_map(lambda x: x[0], st.params)
            test_acc = float(resnet20_accuracy(p0, test_b))
            train_acc = float(resnet20_accuracy(p0, train_b))
        history.append(dict(
            epoch=e, loss=float(m["loss"]), test_acc=test_acc, train_acc=train_acc,
            gen_gap=train_acc - test_acc, disagreement=float(m["disagreement"]),
            effective_rounds=float(m["effective_rounds"]),
            local_seconds=m["local_seconds"], consensus_seconds=m["consensus_seconds"],
        ))
    return topo.lambda2(), history


def _schedule_spec(args) -> str:
    """The CSV's schedule column: the spec, with its churn."""
    spec = args.schedule or "static"
    if args.agent_dropout or args.edge_dropout:
        spec += (f"+churn(agent {args.agent_dropout}, edge {args.edge_dropout}, "
                 f"seed {args.schedule_seed})")
    return spec


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    flags = configure_precision(conv_tf32=True)
    print(f"device {device}  {flags}", flush=True)
    wire = "exact f32"
    if args.codec:
        template = init_resnet20(torch.Generator().manual_seed(0), width=args.width, device="meta")
        wire = f"{args.codec} ({compression_ratio(template, args.codec):.1f}x vs f32)"
    print(f"consensus path: {args.consensus_path}, wire codec: {wire}, schedule: {_schedule_spec(args)}, "
          f"momentum {args.consensus_momentum}, rounds policy: {args.rounds_policy or PAPER.consensus_steps}")
    shards, test = make_data(args)
    rows = []
    print(f"{'topology':12s} {'lambda2':>8s} {'algorithm':>10s} {'test acc':>9s} "
          f"{'gen gap':>8s} {'disagree':>9s}  time")
    for topo_name in args.topologies.split(","):
        for algo in ("classical", "drt"):
            t0 = time.perf_counter()
            lam2, hist = run_experiment(args, topo_name, algo, shards, test, device)
            last = hist[-1]
            print(f"{topo_name:12s} {lam2:8.3f} {algo:>10s} {last['test_acc']:9.3f} "
                  f"{last['gen_gap']:8.3f} {last['disagreement']:9.4g}  "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            rows += [dict(topology=topo_name, schedule=_schedule_spec(args), lambda2=lam2, algorithm=algo, **h)
                     for h in hist]
    if args.out_csv:
        with open(args.out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.out_csv}")


if __name__ == "__main__":
    main()
