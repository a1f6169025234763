"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (every failure raises; nothing is caught):
1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   both TF32 switches;
2. build every kernel of the main path from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at small odd shapes, and time kernel, plain
   version and one PyTorch library call of the same function (CUDA events,
   L2 flushed before each launch, median);
4. drive the main path through ``repro_torch.experiment``: the paper's
   configuration (K=16 agents, ResNet-20 width 16, 32x32 images, batch 128),
   ring, two DRT epochs and one classical epoch, with the launch counters
   set to 0 just before and read just after;
5. run one small epoch (K=4, width 4, 8x8 images, TF32 off) from the same
   weights on the CPU (plain versions) and on the card (kernels) and compare.

Prints the card's line, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or without the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MAIN_TOL = 1e-5  # kernel vs plain, f32 sums of K=16 O(1) products in another order


def _ms_median(fn, reps, flush):
    """Median device milliseconds of ``fn()`` over ``reps`` launches, each
    timed alone with CUDA events after ``flush()`` evicted the L2 cache."""
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")


def phase_build():
    from repro_torch.kernels import build

    secs = build.build_all()
    print(f"built {list(build.KERNELS)} in {secs:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc[{name}] {line}")


def _main_path_slab(device):
    """The main path's combine operands: the width-16 ResNet-20 layout
    (K=16, 2,416 blocks), a packed slab of 16 agents' weights (so lane
    padding is the layout's own) and seeded column-stochastic mixing."""
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_map

    K = 16
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda *xs: torch.stack(xs), *[init_resnet20(g, width=16) for _ in range(K)])
    t = agent_template(params)
    layout = build_slab_layout(LayerPartition.build(t), t)
    slab = layout.pack(params).to(device)
    rng = np.random.default_rng(0)
    A = np.ascontiguousarray(rng.dirichlet(np.ones(K), size=(layout.num_layers, K)).swapaxes(1, 2), np.float32)
    A_blocks = torch.from_numpy(A).to(device)[layout.block_layer_on(device)].contiguous()
    return layout, A_blocks, slab


def phase_kernels(device):
    from repro_torch.kernels.slab_combine import LANES, MAX_AGENTS, slab_combine, slab_combine_ref

    layout, A_blocks, slab = _main_path_slab(device)
    K, D = slab.shape
    nb = A_blocks.shape[0]
    out = slab_combine(A_blocks, slab)
    torch.cuda.synchronize()
    ref = slab_combine_ref(A_blocks, slab)
    err = float((out - ref).abs().max())
    print(f"slab_combine K={K} nb={nb} D={D}: max |kernel - plain| = {err:.3e} (tol {MAIN_TOL})")
    assert err <= MAIN_TOL, err
    for (s, e), size in zip(layout.layer_slices, layout.layer_sizes):
        assert torch.all(out[:, s + size : e] == 0), "lane padding must stay exactly zero"

    rng = np.random.default_rng(1)
    for k, n in [(3, 1), (4, 5), (3, 7), (MAX_AGENTS, 3)]:
        a = np.ascontiguousarray(rng.dirichlet(np.ones(k), size=(n, k)).swapaxes(1, 2), np.float32)
        x = rng.normal(size=(k, n * LANES)).astype(np.float32)
        x.reshape(k, n, LANES)[:, :, -3:] = 0.0
        a_t, x_t = torch.from_numpy(a).to(device), torch.from_numpy(x).to(device)
        o = slab_combine(a_t, x_t)
        torch.cuda.synchronize()
        e_small = float((o - slab_combine_ref(a_t, x_t)).abs().max())
        print(f"slab_combine K={k} nb={n}: max |kernel - plain| = {e_small:.3e} (tol {MAIN_TOL})")
        assert e_small <= MAIN_TOL, (k, n, e_small)
        assert torch.all(o.view(k, n, LANES)[:, :, -3:] == 0)

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    x3 = slab.view(K, nb, LANES)
    fns = {
        "ms": lambda: slab_combine(A_blocks, slab),
        "plain_ms": lambda: slab_combine_ref(A_blocks, slab),
        "library_ms": lambda: torch.einsum("blk,lbc->kbc", A_blocks, x3),
    }
    lib_err = float((torch.einsum("blk,lbc->kbc", A_blocks, x3).reshape(K, D) - ref).abs().max())
    assert lib_err <= MAIN_TOL, lib_err
    for f in fns.values():  # warm up
        f()
    timed = {name: _ms_median(f, 50, flush) for name, f in fns.items()}
    n_bytes = 4 * (2 * K * D + nb * K * K)
    n_flops = 2 * K * K * D
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"slab_combine timing (median of 50, L2 flushed): kernel {timed['ms']:.4f} ms, "
          f"plain {timed['plain_ms']:.4f} ms, torch.einsum {timed['library_ms']:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.3f} GFLOP); "
          f"achieved {n_bytes / timed['ms'] / 1e6:.0f} GB/s")
    return {
        "name": "slab_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slab_combine.cu",
        "replaces": "src/repro/kernels/slab_combine.py:63",
        "launches": None,
        "max_abs_err": err,
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": timed["library_ms"],
    }


def phase_main_path(device):
    from repro_torch import experiment
    from repro_torch.kernels.slab_combine import slab_combine

    args = experiment.parse_args(["--topologies", "ring", "--epochs", "2"])
    flags = experiment.configure_precision(conv_tf32=True)
    print(f"main path: K={args.agents} width={args.width} image={args.image_size} "
          f"batch={args.batch} ring, {flags}")
    t0 = time.perf_counter()
    shards, test = experiment.make_data(args)
    print(f"data: {sum(len(y) for _, y in shards)} samples over {len(shards)} agents "
          f"in {time.perf_counter() - t0:.1f} s")
    runs = [("drt", 2), ("classical", 1)]
    slab_combine.launches = 0
    hist = {}
    for algo, epochs in runs:
        args.epochs = epochs
        _, hist[algo] = experiment.run_experiment(args, "ring", algo, shards, test, device)
    launches = slab_combine.launches
    for algo, _ in runs:
        for h in hist[algo]:
            print(f"  {algo:9s} epoch {h['epoch']}: loss {h['loss']:.4f} "
                  f"disagreement {h['disagreement']:.6g} test_acc {h['test_acc']:.3f} "
                  f"local {h['local_seconds']:.3f} s consensus {h['consensus_seconds']:.4f} s")
            assert math.isfinite(h["loss"]), h
            assert math.isfinite(h["disagreement"]) and h["disagreement"] >= 0.0, h
    round_sets = sum(e for _, e in runs)
    print(f"slab_combine launches on the main path: {launches} (round-sets run: {round_sets})")
    assert launches == round_sets, (launches, round_sets)
    return launches


def phase_cpu_vs_card(device):
    """One K=4 epoch from the same weights on both devices, TF32 off.
    Per-step f32 conv rounding differs between cuDNN and the CPU; over
    three steps and three mixing rounds: loss to 1e-4 relative, parameters
    to 1e-4 absolute, disagreement (a difference of Gram entries) to 1e-6 x
    mean_k ||x_k||^2."""
    from repro_torch import bridge, experiment
    from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
    from repro_torch.core.topology import ring
    from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
    from repro_torch.kernels.slab_combine import slab_combine
    from repro_torch.models.resnet import init_resnet20, resnet20_agent_losses
    from repro_torch.optim.optimizers import momentum
    from repro_torch.utils.pytree import tree_items

    experiment.configure_precision(conv_tf32=False)
    K = 4
    p0 = bridge.params_to_jax(init_resnet20(torch.Generator().manual_seed(5), width=4))
    rng = np.random.default_rng(5)
    w0 = {k: {n: x[None] + 0.02 * rng.normal(size=(K, *x.shape)).astype(np.float32)
              for n, x in g.items()} for k, g in p0.items()}
    data = CifarLike(CifarLikeConfig(image_size=8, noise=0.1, max_shift=0))
    batches = agent_minibatches(
        data.paper_partition(num_agents=K, min_samples=24, max_samples=30, seed=1), 8, 0
    )
    out = {}
    for dev in (torch.device("cpu"), device):
        for algo in ("drt", "classical"):
            tr = DecentralizedTrainer(
                resnet20_agent_losses, lambda g: init_resnet20(g, width=4),
                momentum(0.05, 0.9), ring(K), TrainerConfig(algorithm=algo), device=dev,
            )
            before = slab_combine.launches
            st, m = tr.epoch(tr.state_from_params(bridge.params_from_jax(w0, device=dev)), batches)
            assert slab_combine.launches == before + (dev.type == "cuda")
            out[dev.type, algo] = (st.params, float(m["loss"]), float(m["disagreement"]))
    for algo in ("drt", "classical"):
        (pc, lc, dc), (pg, lg, dg) = out["cpu", algo], out["cuda", algo]
        leaves_c = [x for _, x in tree_items(pc)]
        leaves_g = [x.cpu() for _, x in tree_items(pg)]
        perr = max(float((a - b).abs().max()) for a, b in zip(leaves_c, leaves_g))
        scale = sum(float(x.double().square().sum()) for x in leaves_c) / K
        print(f"cpu vs card, {algo}: loss {lc:.7f} / {lg:.7f}, disagreement {dc:.7g} / {dg:.7g}, "
              f"max |param diff| {perr:.3e}")
        assert abs(lc - lg) <= 1e-4 * abs(lc), (lc, lg)
        assert perr <= 1e-4, perr
        assert abs(dc - dg) <= 1e-6 * scale, (dc, dg, scale)
    experiment.configure_precision(conv_tf32=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    phase_card()
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    phase_build()
    kernel = phase_kernels(device)
    kernel["launches"] = phase_main_path(device)
    phase_cpu_vs_card(device)
    print(f"chip_smoke phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
