"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (every failure raises; nothing is caught):
1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   both TF32 switches;
2. build every kernel of the main paths from ``src/repro_torch/kernels/csrc``
   (``slab_combine``, ``slab_codec``, ``slab_segment``, ``drt_dist``,
   ``flash_attention``, ``selective_scan``, ``combine`` and ``quantize``:
   one nvcc per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at small odd shapes, and time kernel, plain
   version and, where one exists, one PyTorch library call of the same
   function (CUDA events, L2 flushed before each call, a device sleep first
   so the events see device time only; median):
   ``slab_combine``; ``slab_quant_encode`` (bit for bit; it runs the
   wire view that ``slab_encode_combine`` hashes in-kernel, so it proves
   that wire); ``slab_encode_combine`` for every wire mode x algorithm
   (out and A within f32 tolerances, two runs bit-identical);
   ``slab_edge_encode_combine`` for every wire mode x algorithm on the ring
   and the hypercube and ``slab_edge_combine`` (the edge path's kernels:
   out and the edge factors within f32 tolerances, the combine bit for bit
   with the plain one given the kernel's factors, two runs bit-identical,
   destination halves joined equal to the whole), also at K=3, 5, 64 on a
   padded churn edge list with an isolated agent; the permute engine's
   ``drt_dist`` (every layer slot of the width-16 slab and sizes 1, 127,
   129, 10^6+3: relative 1e-5 of each sum, two runs bit-identical, two
   launches a call) and ``slab_source_combine`` (the main shape at N = 3, 5
   and the Erdos-Renyi N, and N = 1, 64 at odd widths: bit for bit); the
   LM kernels: ``flash_attention`` at the qwen3-4b prefill shape (B 4, 32
   query heads over 8 KV heads, S 2048, hd 128) in bf16 and f32, at S 2047
   and 37 (one partial tile), causal as the decoder's prefill, timed beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls), and
   ``selective_scan`` at the falcon-mamba-7b prefill shape (B 4, S 2048, di
   8192, ds 16) with x bf16 and f32, y and h_last, at S 2047 and 37; the
   kernel API's kernels on the K=16 width-16 slab, every call of its path:
   ``weighted_combine`` (11 layer slots), ``dequant_combine`` (68 slot and
   leaf pieces), ``int8_quantize`` / ``int8_dequantize`` bit for bit,
   ``slab_dequant_combine`` within MAIN_TOL, and at K = 3, 5, 64 with
   ragged widths and bf16 / f16 inputs;
4. drive the main paths through ``repro_torch.experiment``: the paper's
   configuration (K=16 agents, ResNet-20 width 16, 32x32 images, batch 128),
   ring.  The exact path (slice 1): two DRT epochs and one classical epoch.
   The coded path: int8 with two DRT epochs and one classical epoch, then
   one DRT epoch each with bf16, f16 and topk:0.1 (it launches no
   ``slab_quant_encode``).  The wire-encode path: the int8 wire of the
   main path's slab for three rounds' keys through
   ``consensus.slab_encode_batched``.  Each path runs with the launch
   counters set to 0 just before and read just after.  The edge path
   (``--consensus-path edge``): on the ring two exact DRT epochs, one exact
   classical epoch, two int8 DRT epochs and one DRT epoch each with bf16,
   f16 and topk:0.1; one exact DRT epoch each on Erdos-Renyi and the
   hypercube; every round launches ``slab_edge_encode_combine`` (and an
   int8 round ``slab_quant_encode`` once), no dense kernel.  The scatter
   edge path: one exact DRT round-set at the main shape without CSR
   tables, through ``slab_edge_combine``.  The permute path
   (``PermuteConsensus`` through ``spmd_run``, 16 agents as 16 threads on
   the card, 3 rounds from K=16 width-16 agents drawn apart): on the ring
   DRT exact, int8, bf16 and topk:0.1 and classical exact, on Erdos-Renyi
   and the hypercube DRT exact; each against the gather engine on the same
   weights, its launches asserted to the engine's formulas (``drt_dist``
   rounds x exchanges x L calls per agent, one ``slab_source_combine`` per
   agent and round, int8 one ``slab_quant_encode`` per agent and round, no
   dense or edge kernel).  The LM serving path (``repro_torch.launch.serve``)
   at full width and depth, random weights made on the card: qwen3-4b, then
   falcon-mamba-7b, batch 4, prompt 2048, 32 new tokens; one
   ``flash_attention`` per attention layer (36) or one ``selective_scan``
   per Mamba layer (64) in the prefill, none in decode, logits finite.  The
   kernel API path on the main path's slab: ``combine_slab_per_slot`` (11
   ``weighted_combine``), ``dequant_combine_slab_kernels`` (1
   ``slab_dequant_combine``), ``dequant_combine_slab_per_slot`` (68
   ``dequant_combine``), ``int8_quantize`` / ``int8_dequantize`` per layer
   segment (11 each), each against its whole-slab partner; the tree oracle
   at full width (K=16, 3 rounds, ring, 5 codecs x 2 algorithms) against
   the slab path, no kernel launched on the tree path; then,
   outside the counted run, ``torch.profiler`` over one more prefill and 8
   decode steps of each: device time by kernel category and the device's
   busy share;
5. from the same weights on the CPU (plain versions) and on the card
   (kernels), TF32 off, K=4, width 4, 8x8 images: one exact epoch per
   algorithm; one int8 round (identical wire, f32 tolerance) and its wire
   through ``dequant_combine_slab_kernels``; one int8 DRT epoch (tolerance in quantization steps); one exact DRT edge epoch
   and one int8 DRT edge round; one exact and one int8 DRT permute
   round-set (3 rounds); the smoke LMs (qwen3-4b-smoke, falcon-mamba-7b-smoke,
   f32): forward logits, prefill logits and caches, 4 teacher-forced decode
   steps.

Prints the card's line, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or without the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import math
import os
import re
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
# mixing weights (<= 1), kernel vs plain version, both on the card: the Gram
# summed in another order (the plain version's index_add_ uses atomics there,
# so its order, and its last bits, change from run to run; readings in
# PERF.md) and CUDA's logf/expf against torch's
A_TOL = 5e-6
# mixing weights, CPU plain version vs card kernel: both deterministic; the
# reference's own tolerance for its fused vs unfused round, as the CPU
# parity tests hold it
ROUND_A_TOL = 1e-6


QUEUE_CYCLES = 10_000_000  # ~6 ms of device sleep: time for the host to enqueue a call


def _ms_median(fn, reps, flush, queued=True):
    """Median device milliseconds of ``fn()`` over ``reps`` calls, each
    timed alone with CUDA events after ``flush()`` evicted the L2 cache.

    ``queued``: a device sleep runs first, so the host enqueues the whole
    call before the device reaches it and the events see device time only
    (no gaps while the host issues a multi-launch call).  ``queued=False``
    times the call as the host issues it."""
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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
        # one line per kernel from ptxas's report: registers, spills, smem
        fn = None
        for line in log.splitlines():
            m = re.search(r"Function properties for .*?([a-z][a-z_]*_kernel)", line)
            if m:
                fn = m.group(1)
            elif fn and "spill" in line:
                spill = line.strip()
            elif fn and "Used" in line:
                print(f"  nvcc[{name}] {fn}: {line.split(':', 1)[1].strip()}; {spill}")
                fn = None


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
    issued_ms = _ms_median(fns["ms"], 50, flush, queued=False)
    n_bytes = 4 * (2 * K * D + nb * K * K)
    n_flops = 2 * K * K * D
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"slab_combine timing (median of 50, L2 flushed, device time): kernel {timed['ms']:.4f} ms "
          f"({issued_ms:.4f} ms as issued), "
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


def _codec_operands(K, nb, seed, L=3):
    """Seeded small operands of the slab_codec kernels on the card: a slab,
    the int8 wire operands, a top-k-like sent slab, a sorted block map."""
    from repro_torch.comm.prng import words_to_tensor
    from repro_torch.kernels.slab_codec import LANES

    rng = np.random.default_rng(seed)
    D = nb * LANES
    slab = rng.normal(size=(K, D)).astype(np.float32)
    scales = (np.abs(slab).max() / 127.0 * rng.uniform(0.5, 1.0, size=(K, 4))).astype(np.float32)
    col_seg = np.sort(rng.integers(0, 4, D)).astype(np.int32)
    col_leaf = np.sort(rng.integers(0, 6, D)).astype(np.int32)
    col_idx = rng.integers(0, 2**31, D).astype(np.int32)
    w = rng.integers(0, 2**32, size=(2, K, 6), dtype=np.uint64).astype(np.uint32)
    bl = np.sort(np.concatenate([np.arange(L), rng.integers(0, L, max(nb - L, 0))]))[:nb].astype(np.int32)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    ops = (t(scales), t(col_seg), t(col_leaf), t(col_idx),
           words_to_tensor(w[0], "cuda"), words_to_tensor(w[1], "cuda"))
    return t(slab), ops, t(np.where(np.abs(slab) > 1.0, slab, 0.0).astype(np.float32)), t(bl), L


def _bound(n_bytes, n_flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_codec_kernels(device):
    """slab_quant_encode and slab_encode_combine against their plain
    versions at the main path's shapes (the width-16 ResNet-20 layout, K=16,
    the real column maps and round keys) and at small odd shapes; timings
    and bounds.  Returns the two JSON entries (launches filled in later)."""
    from repro_torch.comm import prng
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus, packing
    from repro_torch.core.topology import ring
    from repro_torch.kernels import slab_codec as sc

    layout, _, slab = _main_path_slab(device)
    K, D = slab.shape
    nb, L = layout.n_blocks, layout.num_layers
    keys = prng.fold_in(prng.fold_in(prng.key(0), 3), np.arange(K))
    int8_ops = packing.int8_wire_operands(make_codec("int8"), layout, slab, keys)
    bl = layout.maps_on(device)["block_layer"]
    topo = ring(K)
    mixes = {
        "drt": torch.as_tensor(topo.c_matrix(), dtype=torch.float32, device=device),
        "classical": torch.as_tensor(topo.metropolis(), dtype=torch.float32, device=device),
    }
    sent, _ = consensus.slab_encode_batched(make_codec("topk:0.1"), layout, slab, (), keys)
    ops_of = {"int8": int8_ops, "bf16": (), "f16": (), "sent": (sent,)}

    # the int8 wire, bit for bit: on the card and against the CPU's plain version
    q = sc.slab_quant_encode(*int8_ops, slab)
    torch.cuda.synchronize()
    q_ref = sc.slab_quant_encode_ref(*int8_ops, slab)
    q_cpu = sc.slab_quant_encode(*(t.cpu() for t in int8_ops), slab.cpu())
    n_diff = int((q != q_ref).sum())
    print(f"slab_quant_encode K={K} nb={nb}: {n_diff} of {q.numel()} int8 values differ from the "
          f"plain version on the card, {int((q.cpu() != q_cpu).sum())} from the CPU's; "
          f"|q| max {int(q.abs().max())}")
    assert n_diff == 0 and torch.equal(q.cpu(), q_cpu)
    for k, n in [(3, 1), (5, 7), (3, 5), (sc.MAX_AGENTS, 3)]:
        x, ops, _, _, _ = _codec_operands(k, n, seed=k * 100 + n)
        qs = sc.slab_quant_encode(*ops, x)
        torch.cuda.synchronize()
        assert torch.equal(qs, sc.slab_quant_encode_ref(*ops, x)), (k, n)
    print("slab_quant_encode small shapes K=3,5,64: bit-exact")

    errs = {}
    for algo, mix in mixes.items():
        for mode, ops in ops_of.items():
            kw = dict(mode=mode, algorithm=algo, num_layers=L, N_clip=2.0 * K)
            out, A = sc.slab_encode_combine(bl, slab, ops, mix, **kw)
            out2, A2 = sc.slab_encode_combine(bl, slab, ops, mix, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, out2) and torch.equal(A, A2), ("not bit-reproducible", mode, algo)
            out_ref, A_ref = sc.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
            e_out = float((out - out_ref).abs().max())
            e_A = float((A - A_ref).abs().max())
            errs[mode, algo] = e_out
            print(f"slab_encode_combine {algo:9s} {mode:4s} K={K} nb={nb} L={L}: max |out - plain| "
                  f"{e_out:.3e} (tol {MAIN_TOL}), max |A - plain| {e_A:.3e} (tol {A_TOL}), "
                  f"two runs identical")
            assert e_out <= MAIN_TOL and e_A <= A_TOL, (mode, algo, e_out, e_A)
            for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
                assert torch.all(out[:, s0 + size : e0] == 0), "lane padding must stay exactly zero"
    for k, n in [(3, 2), (5, 7), (sc.MAX_AGENTS, 3)]:
        x, ops, snt, blk, Ls = _codec_operands(k, n, seed=k + n)
        t = ring(k)
        for algo, m in (("drt", t.c_matrix()), ("classical", t.metropolis())):
            m = torch.as_tensor(m, dtype=torch.float32, device=device)
            for mode, o in (("int8", ops), ("bf16", ()), ("f16", ()), ("sent", (snt,))):
                kw = dict(mode=mode, algorithm=algo, num_layers=Ls, N_clip=2.0 * k)
                out, A = sc.slab_encode_combine(blk, x, o, m, **kw)
                torch.cuda.synchronize()
                out_ref, A_ref = sc.slab_encode_combine_ref(blk, x, o, m, **kw)
                assert float((out - out_ref).abs().max()) <= MAIN_TOL, (k, n, mode, algo)
                assert float((A - A_ref).abs().max()) <= A_TOL, (k, n, mode, algo)
    print("slab_encode_combine small shapes K=3,5,64 x 4 modes x 2 algorithms: within tolerance")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    maps_bytes = 3 * 4 * D  # col_seg, col_leaf, col_idx (int32)
    small_bytes = 4 * (int8_ops[0].numel() + int8_ops[4].numel() + int8_ops[5].numel())
    timed = {}
    for (mode, algo) in [(m, a) for a in mixes for m in ops_of]:
        ops, mix = ops_of[mode], mixes[algo]
        kw = dict(mode=mode, algorithm=algo, num_layers=L, N_clip=2.0 * K)
        fk = lambda: sc.slab_encode_combine(bl, slab, ops, mix, **kw)  # noqa: E731
        fp = lambda: sc.slab_encode_combine_ref(bl, slab, ops, mix, **kw)  # noqa: E731
        fk(), fp()
        ms, plain_ms = _ms_median(fk, 30, flush), _ms_median(fp, 10, flush)
        issued_ms = _ms_median(fk, 30, flush, queued=False)
        # each input read once, each output written once
        in_bytes = 4 * K * D + 4 * nb + 4 * K * K
        in_bytes += {"int8": maps_bytes + small_bytes, "sent": 4 * K * D}.get(mode, 0)
        out_bytes = 4 * K * D + (4 * L * K * K if algo == "drt" else 0)
        flops = 2 * K * K * D * (2 if algo == "drt" else 1)
        bound_ms, bound_by = _bound(in_bytes + out_bytes, flops)
        timed[mode, algo] = (ms, plain_ms, bound_ms, bound_by)
        print(f"slab_encode_combine timing {algo:9s} {mode:4s} (median, L2 flushed, device time): "
              f"kernel {ms:.4f} ms ({issued_ms:.4f} ms as issued), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms "
              f"({(in_bytes + out_bytes) / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP, {bound_by})")
    fk = lambda: sc.slab_quant_encode(*int8_ops, slab)  # noqa: E731
    fp = lambda: sc.slab_quant_encode_ref(*int8_ops, slab)  # noqa: E731
    fk(), fp()
    q_ms, q_plain_ms = _ms_median(fk, 50, flush), _ms_median(fp, 10, flush)
    q_issued = _ms_median(fk, 50, flush, queued=False)
    q_bytes = 4 * K * D + maps_bytes + small_bytes + K * D
    q_bound, q_by = _bound(q_bytes, 4 * K * D)
    print(f"slab_quant_encode timing (median, L2 flushed, device time): kernel {q_ms:.4f} ms "
          f"({q_issued:.4f} ms as issued), plain "
          f"{q_plain_ms:.4f} ms, bound {q_bound:.4f} ms ({q_bytes / 1e6:.2f} MB, {q_by})")
    ms, plain_ms, bound_ms, bound_by = timed["int8", "drt"]
    return [
        {
            "name": "slab_encode_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slab_codec.cu",
            "replaces": "src/repro/kernels/slab_codec.py:216", "launches": None,
            "max_abs_err": errs["int8", "drt"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        },
        {
            "name": "slab_quant_encode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slab_codec.cu",
            "replaces": "src/repro/kernels/slab_codec.py:359", "launches": None,
            "max_abs_err": float((q.float() - q_ref.float()).abs().max()), "ms": q_ms,
            "plain_ms": q_plain_ms, "bound_ms": q_bound, "bound_by": q_by, "library_ms": None,
        },
    ]


def _edge_list(K, graph, seed=5):
    """(src, dst, w) numpy of one round: a topology's edge list, or a churn
    round of the ring (the reference's ChurnSchedule draw: agents dropped
    with probability 0.25, edges with 0.1; the first round that isolates an
    agent and keeps an edge), padded to the ring's edge count."""
    from repro_torch.core.dynamic import StaticSchedule
    from repro_torch.core.topology import PAPER_ER_SEED, Topology, make_topology, ring

    if graph != "churn":
        kw = dict(p=0.1, seed=PAPER_ER_SEED) if graph == "erdos_renyi" else {}
        return tuple(a[0] for a in StaticSchedule(make_topology(graph, K, **kw))._edge_table)
    base = ring(K).adjacency
    for t in range(64):
        rng = np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(1, t)))
        alive = rng.random(K) >= 0.25
        keep = np.triu(rng.random((K, K)) >= 0.1, k=1)
        adj = base & (keep | keep.T) & alive[:, None] & alive[None, :]
        if (~alive).any() and adj.any():
            break
    src, dst, w = (a[0] for a in StaticSchedule(Topology("churn", adj))._edge_table)
    return tuple(np.pad(a, (0, int(base.sum()) - src.shape[0])) for a in (src, dst, w))


def _edge_operands(K, src, dst, w, device):
    """The edge list on the card and its CSR tables."""
    from repro_torch.core.dynamic import csr_from_edges

    edges = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (src, dst, w))
    dmax = max(int(np.bincount(dst[w > 0], minlength=K).max()), 1)
    return edges, csr_from_edges(*edges, K, dmax)[:3]


def _edge_wires(layout, slab, device):
    """Every mode's wire of the main path's slab: the slab, its int8 wire
    (round keys of round 3), the casts and the top-k sent slab."""
    from repro_torch.comm import prng
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus

    keys = prng.fold_in(prng.fold_in(prng.key(0), 3), np.arange(slab.shape[0]))
    q = consensus.slab_encode_batched(make_codec("int8"), layout, slab, None, keys)[0]
    sent, _ = consensus.slab_encode_batched(make_codec("topk:0.1"), layout, slab, None, keys)
    return {"exact": (slab,), "int8": (q.q, q.s, layout.maps_on(device)["col_seg"]),
            "bf16": (slab.to(torch.bfloat16),), "f16": (slab.to(torch.float16),), "sent": (sent,)}


def _check_edge_round(ss, bl, x, wire, edges, csr, label, **kw):
    """One slab_edge_encode_combine call against its plain version on the
    card: two runs bit-identical; out within MAIN_TOL, the factors within
    A_TOL; the CSR combine given the kernel's factors bit for bit.
    Returns max |out - plain|."""
    out, A_self, A_e = ss.slab_edge_encode_combine(bl, x, wire, *edges, *csr, **kw)
    again = ss.slab_edge_encode_combine(bl, x, wire, *edges, *csr, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((out, A_self, A_e), again)), ("not bit-reproducible", label)
    r_out, r_self, r_e = ss.slab_edge_encode_combine_ref(bl, x, wire, *edges, *csr, **kw)
    e_out = float((out - r_out).abs().max())
    e_A = max(float((A_self - r_self).abs().max()), float((A_e - r_e).abs().max()))
    assert e_out <= MAIN_TOL and e_A <= A_TOL, (label, e_out, e_A)
    dec = ss.decode_wire_ref(kw["mode"], wire)
    assert torch.equal(out, ss.csr_combine_ref(bl, x, dec, *csr, A_self, A_e)), ("combine bits", label)
    return out, e_out, e_A


def _check_scatter_round(ss, bl, x, dec, edges, label, **kw):
    """One slab_edge_combine call: two runs bit-identical; out and the
    factors against the plain version on the card; the CPU's scatter
    combine (index_add_ in edge-list order) given the kernel's factors bit
    for bit.  Returns max |out - plain|."""
    from repro_torch.core import packing

    out, A_self, A_e = ss.slab_edge_combine(bl, x, dec, *edges, **kw)
    again = ss.slab_edge_combine(bl, x, dec, *edges, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((out, A_self, A_e), again)), ("not bit-reproducible", label)
    r_out, r_self, r_e = ss.slab_edge_combine_ref(bl, x, dec, *edges, **kw)
    e_out = float((out - r_out).abs().max())
    e_A = max(float((A_self - r_self).abs().max()), float((A_e - r_e).abs().max()))
    assert e_out <= MAIN_TOL and e_A <= A_TOL, (label, e_out, e_A)
    cpu = packing.edge_combine(A_self.cpu(), A_e.cpu(), edges[0].cpu(), edges[1].cpu(), x.cpu(),
                               dec.cpu(), bl.cpu())
    assert torch.equal(out.cpu(), cpu), ("scatter bits", label)
    return e_out


def phase_edge_kernels(device):
    """slab_edge_encode_combine and slab_edge_combine against their plain
    versions at the main path's shapes (the width-16 ResNet-20 layout, K=16,
    ring and hypercube, every mode x algorithm) and at small odd shapes (a
    padded churn edge list with an isolated agent); destination halves;
    timings and bounds.  Returns the two JSON entries (launches filled in
    later)."""
    from repro_torch.kernels import slab_segment as ss

    layout, _, slab = _main_path_slab(device)
    K, D = slab.shape
    nb, L = layout.n_blocks, layout.num_layers
    bl = layout.maps_on(device)["block_layer"]
    wires = _edge_wires(layout, slab, device)
    graphs = {g: _edge_operands(K, *_edge_list(K, g), device) for g in ("ring", "hypercube")}
    errs = {}
    for g, (edges, csr) in graphs.items():
        E, dmax = edges[0].shape[0], csr[0].shape[1]
        for algo in ("drt", "classical"):
            for mode, wire in wires.items():
                kw = dict(mode=mode, algorithm=algo, num_layers=L, N_clip=2.0 * K)
                out, e_out, e_A = _check_edge_round(ss, bl, slab, wire, edges, csr, (g, mode, algo), **kw)
                errs[g, mode, algo] = e_out
                print(f"slab_edge_encode_combine {g:9s} {algo:9s} {mode:5s} K={K} E={E} Dmax={dmax} "
                      f"nb={nb}: max |out - plain| {e_out:.3e} (tol {MAIN_TOL}), max |A - plain| "
                      f"{e_A:.3e} (tol {A_TOL}), two runs identical, combine bit-exact")
                for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
                    assert torch.all(out[:, s0 + size : e0] == 0), "lane padding must stay exactly zero"
                if (mode, algo) in (("exact", "drt"), ("int8", "classical")):
                    halves = [ss.slab_edge_encode_combine(
                        bl, slab[b:e].contiguous(), wire, *edges, *(c[b:e].contiguous() for c in csr), b, **kw
                    )[0] for b, e in ((0, K // 2), (K // 2, K))]
                    assert torch.equal(torch.cat(halves), out), ("dst_base halves", g, mode, algo)
        dec = _int8_decoded(layout, wires["int8"])
        for algo in ("drt", "classical"):
            kw = dict(algorithm=algo, num_layers=L, N_clip=2.0 * K)
            e = _check_scatter_round(ss, bl, slab, dec, edges, (g, algo), **kw)
            errs[g, "scatter", algo] = e
            print(f"slab_edge_combine {g:9s} {algo:9s} (int8-decoded neighbours) K={K} E={E}: max |out - "
                  f"plain| {e:.3e} (tol {MAIN_TOL}), two runs identical, scatter bit-exact vs CPU")
    print("slab_edge_encode_combine dst_base halves (exact DRT, int8 classical) joined: bit-identical")

    for k, n in [(3, 2), (5, 7), (ss.MAX_AGENTS, 3)]:
        x, int8_ops, snt, blk, Ls = _codec_operands(k, n, seed=k + 7 * n)
        wk = {"exact": (x,), "int8": (torch.randint(-127, 128, (k, n * 128), dtype=torch.int8, device=device),
                                      int8_ops[0], int8_ops[1]),
              "bf16": (x.to(torch.bfloat16),), "f16": (x.to(torch.float16),), "sent": (snt,)}
        edges, csr = _edge_operands(k, *_edge_list(k, "churn"), device)
        for algo in ("drt", "classical"):
            for mode, wire in wk.items():
                _check_edge_round(ss, blk, x, wire, edges, csr, (k, n, mode, algo), mode=mode,
                                  algorithm=algo, num_layers=Ls, N_clip=2.0 * k)
            _check_scatter_round(ss, blk, x, snt, edges, (k, n, algo), algorithm=algo, num_layers=Ls,
                                 N_clip=2.0 * k)
    print("edge kernels small shapes K=3,5,64 on a padded churn list with an isolated agent, "
          "5 modes x 2 algorithms: within tolerance, bit-reproducible, combines bit-exact")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    edges, csr = graphs["ring"]
    E = edges[0].shape[0]
    n_real = int((edges[2] > 0).sum())
    small = 4 * (3 * E + 3 * csr[0].numel() + nb) + 4 * L * (K + E)  # edge list, CSR, block map, factors
    timed = {}
    for algo in ("drt", "classical"):
        for mode, wire in wires.items():
            kw = dict(mode=mode, algorithm=algo, num_layers=L, N_clip=2.0 * K)
            fk = lambda: ss.slab_edge_encode_combine(bl, slab, wire, *edges, *csr, **kw)  # noqa: E731
            fp = lambda: ss.slab_edge_encode_combine_ref(bl, slab, wire, *edges, *csr, **kw)  # noqa: E731
            fk(), fp()
            ms, plain_ms = _ms_median(fk, 30, flush), _ms_median(fp, 10, flush)
            issued_ms = _ms_median(fk, 30, flush, queued=False)
            # each input read once, each output written once: the self slab,
            # the wire (the self slab itself on an exact round), the int8
            # scales and column map, the small tables; the output slab
            wire_bytes = 0 if mode == "exact" else sum(t.numel() * t.element_size() for t in wire)
            n_bytes = 4 * K * D + wire_bytes + 4 * K * D + small
            # this run's work: stats 2 K D + 3 E_real D (DRT), the combine
            # K D + 2 E_real D, the int8 decode K D
            flops = (K + 2 * n_real) * D + (2 * K + 3 * n_real) * D * (algo == "drt")
            flops += K * D * (mode == "int8")
            bound_ms, bound_by = _bound(n_bytes, flops)
            timed[mode, algo] = (ms, plain_ms, bound_ms, bound_by)
            print(f"slab_edge_encode_combine timing ring {algo:9s} {mode:5s} (median, L2 flushed, device "
                  f"time): kernel {ms:.4f} ms ({issued_ms:.4f} ms as issued), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP, {bound_by})")
    dec = _int8_decoded(layout, wires["int8"])
    sc_timed = {}
    for algo in ("drt", "classical"):
        kw = dict(algorithm=algo, num_layers=L, N_clip=2.0 * K)
        fk = lambda: ss.slab_edge_combine(bl, slab, dec, *edges, **kw)  # noqa: E731
        fp = lambda: ss.slab_edge_combine_ref(bl, slab, dec, *edges, **kw)  # noqa: E731
        fk(), fp()
        ms, plain_ms = _ms_median(fk, 30, flush), _ms_median(fp, 10, flush)
        issued_ms = _ms_median(fk, 30, flush, queued=False)
        n_bytes = 3 * 4 * K * D + 4 * (3 * E + nb) + 4 * L * (K + E)
        flops = (K + 2 * n_real) * D + (2 * K + 3 * n_real) * D * (algo == "drt")
        bound_ms, bound_by = _bound(n_bytes, flops)
        sc_timed[algo] = (ms, plain_ms, bound_ms, bound_by)
        print(f"slab_edge_combine timing ring {algo:9s} (median, L2 flushed, device time): kernel {ms:.4f} ms "
              f"({issued_ms:.4f} ms as issued), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP, {bound_by})")
    ms, plain_ms, bound_ms, bound_by = timed["exact", "drt"]
    s_ms, s_plain, s_bound, s_by = sc_timed["drt"]
    return [
        {
            "name": "slab_edge_encode_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slab_segment.cu",
            "replaces": "src/repro/kernels/slab_segment.py:379", "launches": None,
            "max_abs_err": errs["ring", "exact", "drt"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        },
        {
            "name": "slab_edge_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slab_segment.cu",
            "replaces": "src/repro/kernels/slab_segment.py:172", "launches": None,
            "max_abs_err": errs["ring", "scatter", "drt"], "ms": s_ms, "plain_ms": s_plain,
            "bound_ms": s_bound, "bound_by": s_by, "library_ms": None,
        },
    ]


def _int8_decoded(layout, wire_ops):
    """The f32 decoded int8 wire (``consensus.slab_decode``)."""
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus

    q, s, _ = wire_ops
    return consensus.slab_decode(make_codec("int8"), layout, consensus.SlabQuant(q, s))


def _wrappers():
    from repro_torch.kernels import ops, slab_codec, slab_segment
    from repro_torch.kernels.flash_attention import flash_attention

    return {
        "flash_attention": flash_attention,
        "selective_scan": ops.selective_scan,
        "slab_combine": ops.slab_combine,
        "drt_dist": ops.drt_dist,
        "slab_source_combine": ops.slab_source_combine,
        "slab_encode_combine": slab_codec.slab_encode_combine,
        "slab_quant_encode": slab_codec.slab_quant_encode,
        "slab_edge_encode_combine": slab_segment.slab_edge_encode_combine,
        "slab_edge_combine": slab_segment.slab_edge_combine,
        "weighted_combine": ops.weighted_combine,
        "int8_quantize": ops.int8_quantize,
        "int8_dequantize": ops.int8_dequantize,
        "dequant_combine": ops.dequant_combine,
        "slab_dequant_combine": ops.slab_dequant_combine,
    }


def _reset_counters():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "calls"):
            fn.calls = 0


def _counters():
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        if hasattr(fn, "calls"):
            out[name + "_calls"] = fn.calls
    return out


def _run_path(args, shards, test, device, runs, topology="ring"):
    """Drive (codec, algorithm, epochs) runs through the experiment entry
    point on ``topology`` with the counters set to 0 just before and read
    just after."""
    from repro_torch import experiment

    _reset_counters()
    hist = []
    for codec, algo, epochs in runs:
        args.codec, args.epochs = codec, epochs
        _, h = experiment.run_experiment(args, topology, algo, shards, test, device)
        hist.append((codec, algo, h))
    counts = _counters()
    for codec, algo, h in hist:
        for e in h:
            print(f"  {topology} {args.consensus_path} {str(codec):9s} {algo:9s} epoch {e['epoch']}: "
                  f"loss {e['loss']:.4f} "
                  f"disagreement {e['disagreement']:.6g} test_acc {e['test_acc']:.3f} "
                  f"local {e['local_seconds']:.3f} s consensus {e['consensus_seconds']:.4f} s")
            assert math.isfinite(e["loss"]), e
            assert math.isfinite(e["disagreement"]) and e["disagreement"] >= 0.0, e
    return counts


def phase_main_path(device):
    from repro_torch import experiment
    from repro_torch.kernels.slab_codec import LAUNCHES_PER_CALL

    args = experiment.parse_args(["--topologies", "ring", "--epochs", "1"])
    flags = experiment.configure_precision(conv_tf32=True)
    print(f"main path: K={args.agents} width={args.width} image={args.image_size} "
          f"batch={args.batch} ring, {flags}")
    t0 = time.perf_counter()
    shards, test = experiment.make_data(args)
    print(f"data: {sum(len(y) for _, y in shards)} samples over {len(shards)} agents "
          f"in {time.perf_counter() - t0:.1f} s")
    rounds = 3  # PAPER.consensus_steps

    exact = [(None, "drt", 2), (None, "classical", 1)]
    c = _run_path(args, shards, test, device, exact)
    round_sets = sum(e for *_, e in exact)
    print(f"exact path launches: {c} (round-sets run: {round_sets})")
    assert c["slab_combine"] == round_sets and c["slab_encode_combine"] == 0, c

    coded = [("int8", "drt", 2), ("int8", "classical", 1), ("bf16", "drt", 1),
             ("f16", "drt", 1), ("topk:0.1", "drt", 1)]
    k = _run_path(args, shards, test, device, coded)
    calls = sum(rounds * e for *_, e in coded)
    launches = sum(rounds * e * LAUNCHES_PER_CALL[a] for _, a, e in coded)
    print(f"coded path launches: {k} (coded rounds {calls}: expect {launches} slab_encode_combine "
          f"launches at {LAUNCHES_PER_CALL} per call, no slab_quant_encode: the int8 wire is "
          f"hashed in-kernel)")
    assert k["slab_encode_combine_calls"] == calls, k
    assert k["slab_encode_combine"] == launches, k
    assert k["slab_quant_encode"] == 0 and k["slab_combine"] == 0, k

    w = phase_wire_encode(device, rounds)
    edge = phase_edge_path(args, shards, test, device, rounds)
    perm = phase_permute_path(device, rounds)
    return {"slab_combine": c["slab_combine"], "slab_encode_combine": k["slab_encode_combine"],
            "slab_quant_encode": w["slab_quant_encode"] + edge["slab_quant_encode"]
            + perm["slab_quant_encode"],
            "slab_edge_encode_combine": edge["slab_edge_encode_combine"],
            "slab_edge_combine": edge["slab_edge_combine"],
            "drt_dist": perm["drt_dist"], "slab_source_combine": perm["slab_source_combine"]}


def phase_edge_path(args, shards, test, device, rounds):
    """The edge main path through the experiment entry point
    (``--consensus-path edge``): each round one ``slab_edge_encode_combine``
    call of ``LAUNCHES_PER_CALL[algorithm]`` launches (an int8 round also
    one ``slab_quant_encode``), no dense kernel; then one exact DRT
    round-set at the main shape without CSR tables, through
    ``slab_edge_combine``.  Returns the launch counts."""
    from repro_torch.kernels.slab_segment import LAUNCHES_PER_CALL

    args.consensus_path = "edge"
    totals = dict.fromkeys(("slab_edge_encode_combine", "slab_quant_encode"), 0)
    paths = [("ring", [(None, "drt", 2), (None, "classical", 1), ("int8", "drt", 2), ("bf16", "drt", 1),
                       ("f16", "drt", 1), ("topk:0.1", "drt", 1)]),
             ("erdos_renyi", [(None, "drt", 1)]), ("hypercube", [(None, "drt", 1)])]
    for topology, runs in paths:
        c = _run_path(args, shards, test, device, runs, topology)
        calls = sum(rounds * e for *_, e in runs)
        launches = sum(rounds * e * LAUNCHES_PER_CALL[a] for _, a, e in runs)
        int8_rounds = sum(rounds * e for cd, _, e in runs if cd == "int8")
        print(f"edge path on {topology}: launches {c} (edge rounds {calls}: expect {launches} "
              f"slab_edge_encode_combine launches at {LAUNCHES_PER_CALL} per call, {int8_rounds} "
              f"slab_quant_encode, no dense kernel)")
        assert c["slab_edge_encode_combine_calls"] == calls, c
        assert c["slab_edge_encode_combine"] == launches, c
        assert c["slab_quant_encode"] == int8_rounds, c
        assert c["slab_combine"] == c["slab_encode_combine"] == c["slab_edge_combine"] == 0, c
        for key in totals:
            totals[key] += c[key]
    args.consensus_path = "slab"
    totals["slab_edge_combine"] = phase_scatter_path(device, rounds)
    return totals


def phase_scatter_path(device, rounds):
    """One exact DRT round-set of the main path's shape (K=16 ResNet-20
    width 16 agents 0.1 apart, ring) on the edge path without CSR tables:
    ``slab_edge_combine``, ``LAUNCHES_PER_CALL["drt"]`` launches a round.
    Checks the output: finite, the input's shape, disagreement contracted,
    and within 1e-5 of the CSR path's (same factors up to sum order)."""
    from repro_torch.core import consensus, dynamic
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.kernels.slab_segment import LAUNCHES_PER_CALL
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

    K = 16
    g = torch.Generator().manual_seed(1)
    p0 = init_resnet20(g, width=16)
    noise = [init_resnet20(g, width=16) for _ in range(K)]
    pK = tree_map(lambda x, *n: (x[None] + 0.1 * torch.stack(n)).to(device), p0, *noise)
    part = LayerPartition.build(agent_template(pK))
    topo = ring(K)
    kw = dict(rounds=rounds, path="edge", edges=dynamic.edge_stacks_from_topology(topo, rounds, device),
              obs=ObsConfig())
    _reset_counters()
    new, A, m = consensus.gather_consensus_rounds(part, pK, topo.c_matrix(), DRTConfig(), **kw)
    c = _counters()
    csr_new, csr_A, _ = consensus.gather_consensus_rounds(
        part, pK, topo.c_matrix(), DRTConfig(), max_in_degree=dynamic.max_in_degree_from_topology(topo), **kw
    )
    err = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(tree_items(new), tree_items(csr_new)))
    print(f"scatter edge path (no CSR tables), K={K} width 16 ring, {rounds} exact DRT rounds: launches {c}; "
          f"disagreement {[round(float(d), 6) for d in m.disagreement]}; max |scatter - CSR| {err:.3e}")
    assert c["slab_edge_combine"] == rounds * LAUNCHES_PER_CALL["drt"], c
    assert c["slab_edge_combine_calls"] == rounds and c["slab_edge_encode_combine"] == 0, c
    assert c["slab_combine"] == c["slab_encode_combine"] == 0, c
    for (_, a), (_, x) in zip(tree_items(new), tree_items(pK)):
        assert a.shape == x.shape and bool(torch.isfinite(a).all())
    assert float(m.disagreement[-1]) < float(m.disagreement[0]) and err <= MAIN_TOL
    torch.testing.assert_close(A, csr_A, rtol=0, atol=A_TOL)
    return c["slab_edge_combine"]


def phase_wire_encode(device, rounds):
    """The wire-encode path: the int8 wire of the main path's slab (K=16,
    width 16) under ``rounds`` rounds' agent keys, through
    ``consensus.slab_encode_batched``, one ``slab_quant_encode`` launch
    each.  Checks the decoded wire: the slab's shape, finite, within half a
    quantization step of the slab, lane padding zero."""
    from repro_torch.comm import prng
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus

    layout, _, slab = _main_path_slab(device)
    codec = make_codec("int8")
    _reset_counters()
    wires = [
        consensus.slab_encode_batched(
            codec, layout, slab, (), prng.fold_in(prng.fold_in(prng.key(0), r), np.arange(slab.shape[0]))
        )[0]
        for r in range(rounds)
    ]
    counts = _counters()
    print(f"wire-encode path launches: {counts} ({rounds} int8 encodes of the K={slab.shape[0]} "
          f"D={slab.shape[1]} slab)")
    assert counts["slab_quant_encode"] == rounds and counts["slab_encode_combine"] == 0, counts
    seg = layout.maps_on(device)["col_seg"].long()
    for wire in wires:
        dec = consensus.slab_decode(codec, layout, wire)
        assert dec.shape == slab.shape and bool(torch.isfinite(dec).all())
        assert bool(((dec - slab).abs() <= wire.s[:, seg] * 1.0001).all())
        for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
            assert torch.all(wire.q[:, s0 + size : e0] == 0), "lane padding must stay exactly zero"
    assert not torch.equal(wires[0].q, wires[1].q), "each round's keys draw other roundings"
    return counts


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

    # int8: one coded round from the same slab (identical wire, f32
    # tolerance: out 1e-5, A 1e-6, the reference's own).  The agents start
    # well apart (spread 0.3, as tests/test_torch_coded_consensus.py holds
    # the port's round against the reference): DRT's distances are
    # differences of Gram entries, so for nearly equal agents (the epoch's
    # spread 0.02) both sides' f32 rounding of the Gram (~eps mean_k
    # ||x_k||^2) is a large share of d2 and moves A beyond 1e-6; the
    # exact comparison above states its tolerance in those units for that
    # reason.
    from repro_torch.comm import prng
    from repro_torch.core import consensus
    from repro_torch.core.drt import DRTConfig
    from repro_torch.kernels import slab_codec
    from repro_torch.utils.pytree import LayerPartition, agent_template

    C = ring(K).c_matrix()
    w_apart = {k: {n: x[None] + 0.3 * rng.normal(size=(K, *x.shape)).astype(np.float32)
                   for n, x in g.items()} for k, g in p0.items()}
    rounds_out = {}
    for dev in (torch.device("cpu"), device):
        pK = bridge.params_from_jax(w_apart, device=dev)
        part = LayerPartition.build(agent_template(pK))
        new, A, _ = consensus.gather_consensus_rounds(
            part, pK, C, DRTConfig(), rounds=1, codec="int8", rng=prng.key(9)
        )
        rounds_out[dev.type] = (new, A)
    (nc, Ac), (ng, Ag) = rounds_out["cpu"], rounds_out["cuda"]
    rerr = max(float((a - b.cpu()).abs().max()) for (_, a), (_, b) in zip(tree_items(nc), tree_items(ng)))
    aerr = float((Ac - Ag.cpu()).abs().max())
    print(f"cpu vs card, one int8 DRT round from the same slab: max |out diff| {rerr:.3e} "
          f"(tol {MAIN_TOL}), max |A diff| {aerr:.3e} (tol {ROUND_A_TOL})")
    assert rerr <= MAIN_TOL and aerr <= ROUND_A_TOL, (rerr, aerr)

    # the fused int8 slab combine: that round's int8 wire of the same slab
    # through dequant_combine_slab_kernels, with the CPU round's A off the
    # diagonal, on both devices: the wire bit for bit, out within MAIN_TOL
    # (f32 sums of K products in another order)
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import packing
    from repro_torch.kernels.slab_combine import slab_dequant_combine

    A_off = Ac * (1.0 - torch.eye(K))
    fused = {}
    for dev in (torch.device("cpu"), device):
        pK = bridge.params_from_jax(w_apart, device=dev)
        layout = packing.build_slab_layout(LayerPartition.build(agent_template(pK)), agent_template(pK))
        keys = prng.fold_in(prng.fold_in(prng.key(9), 0), np.arange(K))
        wire, _ = consensus.slab_encode_batched(make_codec("int8"), layout, layout.pack(pK), (), keys)
        before = slab_dequant_combine.launches
        fused[dev.type] = (wire.q.cpu(), consensus.dequant_combine_slab_kernels(layout, A_off.to(dev), wire).cpu())
        assert slab_dequant_combine.launches == before + (dev.type == "cuda")
    ferr = float((fused["cpu"][1] - fused["cuda"][1]).abs().max())
    print(f"cpu vs card, one int8 wire through dequant_combine_slab_kernels: wire identical "
          f"{torch.equal(fused['cpu'][0], fused['cuda'][0])}, max |out diff| {ferr:.3e} (tol {MAIN_TOL})")
    assert torch.equal(fused["cpu"][0], fused["cuda"][0]) and ferr <= MAIN_TOL, ferr

    # int8: a DRT epoch, tolerance in quantization steps.  After the local
    # steps the sides differ by conv rounding (~1e-6); floor(x / s + u) then
    # lands on the other integer for a few elements, each moving one wire
    # value by one step s <= s_max; the mixing is a convex combination, so
    # over 3 rounds no element differs by more than 3 s_max, and the
    # affected columns stay a small share (<= 2%).  Elsewhere: 1e-4 as above.
    s_max = 1.1 * max(float(np.abs(x).max()) for _, x in tree_items(w0)) / 127.0
    ep = {}
    for dev in (torch.device("cpu"), device):
        tr = DecentralizedTrainer(
            resnet20_agent_losses, lambda g: init_resnet20(g, width=4),
            momentum(0.05, 0.9), ring(K), TrainerConfig(algorithm="drt", codec="int8"), device=dev,
        )
        before = slab_codec.slab_encode_combine.calls
        st, m = tr.epoch(tr.state_from_params(bridge.params_from_jax(w0, device=dev)), batches)
        assert slab_codec.slab_encode_combine.calls == before + 3 * (dev.type == "cuda")
        ep[dev.type] = (st.params, float(m["loss"]))
    (pc, lc), (pg, lg) = ep["cpu"], ep["cuda"]
    cols = n_cols = 0
    worst = 0.0
    for (_, a), (_, b) in zip(tree_items(pc), tree_items(pg)):
        d = (a - b.cpu()).abs().reshape(K, -1)
        worst = max(worst, float(d.max()))
        cols += int((d > 1e-4).any(dim=0).sum())
        n_cols += d.shape[1]
    print(f"cpu vs card, int8 DRT epoch: loss {lc:.7f} / {lg:.7f}, max |param diff| {worst:.3e} "
          f"(bound 3 s_max = {3 * s_max:.3e}), columns apart beyond 1e-4: {cols} of {n_cols}")
    assert abs(lc - lg) <= 1e-4 * abs(lc), (lc, lg)
    assert worst <= 3 * s_max and cols <= 0.02 * n_cols, (worst, cols, n_cols)

    # the edge path: one exact DRT edge epoch (tolerances as the exact
    # epoch's above) and one int8 DRT edge round from the agents 0.3 apart
    # (identical wire; out 1e-5, A 1e-6).  Distances are direct differences
    # on this path, so neither side's rounding scales with the Gram.
    from repro_torch.core import dynamic
    from repro_torch.kernels import slab_segment

    ep = {}
    for dev in (torch.device("cpu"), device):
        tr = DecentralizedTrainer(
            resnet20_agent_losses, lambda g: init_resnet20(g, width=4), momentum(0.05, 0.9), ring(K),
            TrainerConfig(algorithm="drt", consensus_path="edge"), device=dev,
        )
        before = slab_segment.slab_edge_encode_combine.calls
        st, m = tr.epoch(tr.state_from_params(bridge.params_from_jax(w0, device=dev)), batches)
        assert slab_segment.slab_edge_encode_combine.calls == before + 3 * (dev.type == "cuda")
        ep[dev.type] = (st.params, float(m["loss"]), float(m["disagreement"]))
    (pc, lc, dc), (pg, lg, dg) = ep["cpu"], ep["cuda"]
    perr = max(float((a - b.cpu()).abs().max()) for (_, a), (_, b) in zip(tree_items(pc), tree_items(pg)))
    scale = sum(float(x.double().square().sum()) for _, x in tree_items(pc)) / K
    print(f"cpu vs card, exact DRT edge epoch: loss {lc:.7f} / {lg:.7f}, disagreement {dc:.7g} / {dg:.7g}, "
          f"max |param diff| {perr:.3e}")
    assert abs(lc - lg) <= 1e-4 * abs(lc) and perr <= 1e-4 and abs(dc - dg) <= 1e-6 * scale, (lc, lg, perr)

    topo = ring(K)
    rounds_out = {}
    for dev in (torch.device("cpu"), device):
        pK = bridge.params_from_jax(w_apart, device=dev)
        part = LayerPartition.build(agent_template(pK))
        new, A, _ = consensus.gather_consensus_rounds(
            part, pK, C, DRTConfig(), rounds=1, codec="int8", rng=prng.key(9), path="edge",
            edges=dynamic.edge_stacks_from_topology(topo, 1, dev),
            max_in_degree=dynamic.max_in_degree_from_topology(topo),
        )
        rounds_out[dev.type] = (new, A)
    (nc, Ac), (ng, Ag) = rounds_out["cpu"], rounds_out["cuda"]
    rerr = max(float((a - b.cpu()).abs().max()) for (_, a), (_, b) in zip(tree_items(nc), tree_items(ng)))
    aerr = float((Ac - Ag.cpu()).abs().max())
    print(f"cpu vs card, one int8 DRT edge round from the same slab: max |out diff| {rerr:.3e} "
          f"(tol {MAIN_TOL}), max |A diff| {aerr:.3e} (tol {ROUND_A_TOL})")
    assert rerr <= MAIN_TOL and aerr <= ROUND_A_TOL, (rerr, aerr)
    experiment.configure_precision(conv_tf32=True)


DIST_RTOL = 1e-5  # drt_dist vs plain: sums of nonnegative f32 terms in another order, ~80 ulps


def _permute_agents(device, K=16, width=16, seed=11):
    """K ResNet-20 agents drawn independently (the agents apart), each leaf
    moved by N(0, 0.02^2) noise, agent-stacked on ``device``, and their
    layer partition.  The noise unties GroupNorm's initial weights (all
    exactly 1): on tied values top-k's threshold lets last-bit differences
    decide which entries are sent, and the reference's own gather and
    permute engines then differ by O(1) (ROADMAP.md Queue 3)."""
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_map

    g = torch.Generator().manual_seed(seed)
    pK = tree_map(lambda *xs: torch.stack(xs), *[init_resnet20(g, width=width) for _ in range(K)])
    pK = tree_map(lambda x: (x + 0.02 * torch.randn(x.shape, generator=g)).to(device), pK)
    return pK, LayerPartition.build(agent_template(pK))


def phase_permute_kernels(device):
    """drt_dist and slab_source_combine against their plain versions at the
    permute path's shapes (every layer slot of the width-16 slab; the main
    shape with N = 3 ring, 5 hypercube, 7 Erdos-Renyi sources) and at small
    odd shapes; timings and bounds.  Returns the two JSON entries."""
    from repro_torch.core.consensus import exchange_decomposition
    from repro_torch.core.topology import PAPER_ER_SEED, erdos_renyi
    from repro_torch.kernels import drt_dist as dd
    from repro_torch.kernels.slab_combine import (
        LANES, MAX_SOURCES, slab_source_combine, slab_source_combine_ref,
    )

    layout, _, slab = _main_path_slab(device)
    K, D = slab.shape
    nb = layout.n_blocks

    def check_dist(x, y, label):
        before = dd.drt_dist.launches
        got, again = dd.drt_dist(x, y), dd.drt_dist(x, y)
        torch.cuda.synchronize()
        assert dd.drt_dist.launches == before + 2 * dd.LAUNCHES_PER_CALL, label
        assert torch.equal(got, again), ("not bit-reproducible", label)
        ref = dd.drt_dist_ref(x, y)
        rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
        assert rel <= DIST_RTOL, (label, rel)
        return rel, float((got - ref).abs().max())

    errs = [check_dist(slab[0, s:e], slab[1, s:e], ("slot", p)) for p, (s, e) in enumerate(layout.layer_slices)]
    worst, worst_abs = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"drt_dist on the {layout.num_layers} layer slots of the K={K} width-16 slab "
          f"(sizes {[e - s for s, e in layout.layer_slices]}): max relative |kernel - plain| "
          f"{worst:.3e} (tol {DIST_RTOL}; absolute {worst_abs:.3e}), two runs identical, "
          f"{dd.LAUNCHES_PER_CALL} launches a call")
    rng = np.random.default_rng(2)
    for n in (1, 127, 129, 1_000_003):
        x, y = (torch.from_numpy(a).to(device) for a in rng.normal(size=(2, n)).astype(np.float32))
        check_dist(x, y, n)
    print("drt_dist sizes 1, 127, 129, 1000003: within tolerance, two runs identical")

    n_er = 1 + len(exchange_decomposition(erdos_renyi(K, 0.1, PAPER_ER_SEED)))
    srcs_of = {}
    for N, n_blk in [(3, nb), (5, nb), (n_er, nb), (1, 7), (MAX_SOURCES, 13)]:
        w = torch.from_numpy(rng.dirichlet(np.ones(N), size=n_blk).astype(np.float32)).to(device)
        srcs = (slab[:N] if n_blk == nb and N <= K else
                torch.from_numpy(rng.normal(size=(N, n_blk * LANES)).astype(np.float32)).to(device))
        srcs = srcs.contiguous()
        before = slab_source_combine.launches
        out = slab_source_combine(w, srcs)
        torch.cuda.synchronize()
        assert slab_source_combine.launches == before + 1
        assert torch.equal(out, slab_source_combine_ref(w, srcs)), (N, n_blk)
        srcs_of[N, n_blk] = (w, srcs)
    print(f"slab_source_combine N=3, 5, {n_er} at nb={nb} and N=1 (nb=7), {MAX_SOURCES} (nb=13): "
          f"bit-identical with the plain version")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    # drt_dist: one exchange's statistics, the L per-slot calls the engine makes
    pairs = [(slab[0, s:e], slab[1, s:e]) for s, e in layout.layer_slices]
    fk = lambda: [dd.drt_dist(x, y) for x, y in pairs]  # noqa: E731
    fp = lambda: [dd.drt_dist_ref(x, y) for x, y in pairs]  # noqa: E731
    fk(), fp()
    d_ms, d_plain = _ms_median(fk, 50, flush), _ms_median(fp, 20, flush)
    d_issued = _ms_median(fk, 50, flush, queued=False)
    d_bound, d_by = _bound(2 * 4 * D + 4 * 2 * layout.num_layers, 5 * D)
    print(f"drt_dist timing, one exchange's {layout.num_layers} calls (median, L2 flushed, device time): "
          f"kernel {d_ms:.4f} ms ({d_issued:.4f} ms as issued), plain {d_plain:.4f} ms, bound "
          f"{d_bound:.5f} ms ({2 * 4 * D / 1e6:.2f} MB, {d_by}); no single torch call returns both sums")
    timed = {}
    for N in (3, 5, n_er):
        w, srcs = srcs_of[N, nb]
        x3 = srcs.view(N, nb, LANES)
        fk = lambda: slab_source_combine(w, srcs)  # noqa: E731
        fp = lambda: slab_source_combine_ref(w, srcs)  # noqa: E731
        fl = lambda: torch.einsum("bn,nbl->bl", w, x3)  # noqa: E731
        lib_err = float((fl().reshape(-1) - slab_source_combine_ref(w, srcs)).abs().max())
        assert lib_err <= MAIN_TOL, lib_err
        fk(), fp(), fl()
        ms, plain_ms, lib_ms = _ms_median(fk, 50, flush), _ms_median(fp, 20, flush), _ms_median(fl, 50, flush)
        n_bytes = 4 * N * D + 4 * D + 4 * nb * N
        bound_ms, bound_by = _bound(n_bytes, 2 * N * D)
        timed[N] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        print(f"slab_source_combine timing N={N} nb={nb} (median, L2 flushed, device time): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.einsum {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({n_bytes / 1e6:.2f} MB, {bound_by})")
    ms, plain_ms, bound_ms, bound_by, lib_ms = timed[3]
    return [
        {
            "name": "drt_dist", "route": "cuda", "source": "src/repro_torch/kernels/csrc/drt_dist.cu",
            "replaces": "src/repro/kernels/drt_dist.py:50", "launches": None, "max_abs_err": worst_abs,
            "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by, "library_ms": None,
        },
        {
            "name": "slab_source_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slab_combine.cu",
            "replaces": "src/repro/kernels/slab_combine.py:151", "launches": None, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        },
    ]


class _Recording:
    """An exchange that records the tensors its rank puts on the wire."""

    def __init__(self, inner, sent):
        self._inner, self._sent = inner, sent
        self.rank, self.size = inner.rank, inner.size

    def ppermute(self, tensors, perm):
        self._sent.setdefault(self.rank, []).append(tuple(t.clone() for t in tensors))
        return self._inner.ppermute(tensors, perm)


def _run_permute(eng, pK, K, rounds, rng, codec, sent=None):
    """One permute round-set through spmd_run on the card: the agent-stacked
    tree and the host-clock seconds (synchronised)."""
    from repro_torch import spmd_run
    from repro_torch.utils.pytree import tree_leaves, tree_map

    def body(rank, ex):
        if sent is not None:
            ex = _Recording(ex, sent)
        out = eng(tree_map(lambda x: x[rank], pK), ex, rng=rng, rounds=rounds)
        return out[0] if codec else out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = spmd_run(body, K, device=tree_leaves(pK)[0].device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return tree_map(lambda *xs: torch.stack(xs), *outs), secs


def _wire_step_check(got, want, step, label):
    """Rounding and thresholding wires (int8, bf16, top-k) over several
    rounds: beyond the engine tolerance only in < 1% of the elements, and
    there by at most ``step``."""
    from repro_torch.utils.pytree import tree_items

    n_bad = n_all = 0
    worst = 0.0
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        n_bad += int((d > 2e-5 + 2e-4 * b.abs()).sum())
        n_all += d.numel()
    assert n_bad < 0.01 * n_all and worst <= step, (label, n_bad, n_all, worst, step)
    return worst, n_bad, n_all


def phase_permute_path(device, rounds):
    """The permute main path: ``PermuteConsensus`` through ``spmd_run`` at
    the paper's shape (16 agents as 16 threads on the card, width 16, agents
    drawn apart), 3 rounds per case, each case against the gather engine on
    the same weights, its launches asserted.  Returns the launch counts."""
    from repro_torch import PermuteConsensus
    from repro_torch.comm import prng
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus, packing
    from repro_torch.core.consensus import exchange_decomposition
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import PAPER_ER_SEED, make_topology
    from repro_torch.kernels.drt_dist import LAUNCHES_PER_CALL
    from repro_torch.utils.pytree import agent_template, tree_items

    K = 16
    pK, part = _permute_agents(device, K)
    L = part.num_layers
    layout = packing.build_slab_layout(part, agent_template(pK))
    rng = prng.key(5)
    amax = max(float(x.abs().max()) for _, x in tree_items(pK))
    # after round 0 the engines' iterates differ in the last bits, which can
    # flip a rounding (int8: one quantization step; bf16: one bf16 ulp) or
    # whether an entry at top-k's threshold is sent (it moves by its offered
    # value x + residual, below 2 amax)
    steps = {"int8": 1.01 * amax / 127.0, "bf16": amax * 2.0**-7, "topk:0.1": 2.0 * amax}
    cases = [("ring", "drt", None), ("ring", "drt", "int8"), ("ring", "drt", "bf16"),
             ("ring", "drt", "topk:0.1"), ("ring", "classical", None),
             ("erdos_renyi", "drt", None), ("hypercube", "drt", None)]
    # warm-up (layout maps, allocator, host tables): not counted, not timed
    _run_permute(PermuteConsensus(part, make_topology("ring", K), DRTConfig()), pK, K, 1, None, None)
    totals = dict.fromkeys(("drt_dist", "slab_source_combine", "slab_quant_encode"), 0)
    print("permute path round-sets: host clock, 16 agents as 16 threads sharing ONE card and one "
          "interpreter -- not a deployment number (a deployment has one card per agent)")
    for name, algo, codec in cases:
        topo = make_topology(name, K, **(dict(p=0.1, seed=PAPER_ER_SEED) if name == "erdos_renyi" else {}))
        n_ex = len(exchange_decomposition(topo))
        eng = PermuteConsensus(part, topo, DRTConfig(), algorithm=algo, codec=codec)
        sent = {} if codec == "int8" else None
        _reset_counters()
        got, p_secs = _run_permute(eng, pK, K, rounds, rng if codec else None, codec, sent)
        c = _counters()
        want_calls = K * rounds * n_ex * L * (algo == "drt")
        assert c["drt_dist"] == want_calls * LAUNCHES_PER_CALL, (name, algo, codec, c)
        assert c["slab_source_combine"] == K * rounds, c
        assert c["slab_quant_encode"] == K * rounds * (codec == "int8"), c
        assert c["slab_combine"] == c["slab_encode_combine"] == 0, c
        assert c["slab_edge_encode_combine"] == c["slab_edge_combine"] == 0, c
        for key in totals:
            totals[key] += c[key]
        kw = dict(codec=codec, rng=rng) if codec else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = consensus.gather_consensus_rounds(part, pK, topo.c_matrix(), DRTConfig(), rounds=rounds,
                                                 algorithm=algo, metropolis=topo.metropolis(), **kw)[0]
        torch.cuda.synchronize()
        g_secs = time.perf_counter() - t0
        for (_, a), (_, x) in zip(tree_items(got), tree_items(pK)):
            assert a.shape == x.shape and bool(torch.isfinite(a).all())
        if codec == "int8":
            keys = prng.fold_in(prng.fold_in(rng, 0), np.arange(K))
            w0 = consensus.slab_encode_batched(make_codec("int8"), layout, layout.pack(pK), None, keys)[0]
            for k in range(K):
                q, s = sent[k][0]
                assert torch.equal(q[0], w0.q[k]) and torch.equal(s[0], w0.s[k]), ("round-0 wire", k)
        if codec in steps:
            worst, n_bad, n_all = _wire_step_check(got, want, steps[codec], (name, codec))
            note = f"max |diff| {worst:.3e} (one wire step {steps[codec]:.3e}), {n_bad} of {n_all} beyond 2e-4/2e-5"
        else:
            worst = 0.0
            for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
                worst = max(worst, float((a - b).abs().max()))
            note = f"max |diff| {worst:.3e} (rtol 2e-4, atol 2e-5)"
        print(f"  permute {name:11s} {algo:9s} {str(codec):8s} exchanges {n_ex}: launches drt_dist "
              f"{c['drt_dist']} ({want_calls} calls), slab_source_combine {c['slab_source_combine']}, "
              f"slab_quant_encode {c['slab_quant_encode']}; vs gather {note}; round-set "
              f"{p_secs * 1e3:.1f} ms (gather engine {g_secs * 1e3:.1f} ms)")
    return totals


def phase_permute_cpu_vs_card(device):
    """One exact and one int8 DRT permute round-set (K=4 ring, width 4,
    3 rounds, agents drawn apart) from the same weights on the CPU (plain
    versions) and on the card (kernels): exact within MAIN_TOL; int8 within
    one quantization step in < 1% of the elements (a last-bit difference
    after round 0 may flip a stochastic rounding)."""
    from repro_torch import PermuteConsensus, experiment, spmd_run
    from repro_torch.comm import prng
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.utils.pytree import tree_items, tree_map

    experiment.configure_precision(conv_tf32=False)
    K = 4
    pK, part = _permute_agents("cpu", K, width=4, seed=12)
    amax = max(float(x.abs().max()) for _, x in tree_items(pK))
    for codec in (None, "int8"):
        eng = PermuteConsensus(part, ring(K), DRTConfig(), codec=codec)
        outs = {}
        for dev in (torch.device("cpu"), device):
            p = tree_map(lambda x: x.to(dev), pK)

            def body(rank, ex, p=p):
                out = eng(tree_map(lambda x: x[rank], p), ex, rng=prng.key(3), rounds=3)
                return out[0] if codec else out

            outs[dev.type] = tree_map(lambda *xs: torch.stack(xs).cpu(), *spmd_run(body, K, device=dev))
        if codec is None:
            err = max(float((a - b).abs().max()) for (_, a), (_, b) in
                      zip(tree_items(outs["cpu"]), tree_items(outs["cuda"])))
            print(f"cpu vs card, exact DRT permute round-set (K=4, 3 rounds): max |diff| {err:.3e} "
                  f"(tol {MAIN_TOL})")
            assert err <= MAIN_TOL, err
        else:
            worst, n_bad, n_all = _wire_step_check(outs["cuda"], outs["cpu"], 1.01 * amax / 127.0, "int8 permute")
            print(f"cpu vs card, int8 DRT permute round-set (K=4, 3 rounds): max |diff| {worst:.3e}, "
                  f"{n_bad} of {n_all} beyond 2e-4/2e-5 (bound: one step, < 1%)")
    experiment.configure_precision(conv_tf32=True)


# ---------------------------------------------------------------------------
# slice 5: LM serving (dense qwen3-4b, ssm falcon-mamba-7b)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense tensor-core bf16
# exponentials per second of the SMs' multi-function units: 16 ex2 per clock
# per SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) x 132 SMs x 1.98 GHz (H100 SXM boost clock)
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
LM_SERVE = (("qwen3-4b", "flash_attention"), ("falcon-mamba-7b", "selective_scan"))
# the full-shape prefill operands of the two kernels
FA_SHAPE = dict(B=4, H=32, Hkv=8, S=2048, hd=128)
SCAN_SHAPE = dict(B=4, S=2048, di=8192, ds=16)
# kernel vs plain on the card.  f32: sums over keys (scan steps) in another
# order, with and without fused multiply-adds; bf16 out: both round an f32
# result, so they may differ by one bf16 step (2^-7 relative)
FA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-7, 1e-5)}  # (rtol, atol)
SCAN_TOL = 1e-5  # of the largest |value| of y (h_last)
LM_TOL = 1e-4  # CPU vs card, smoke LMs in f32: logits and caches (O(1)), 2 layers


def _attention_operands(B, H, Hkv, S, hd, dtype, seed=0):
    """q, k, v in the model's (B, S, heads, hd) layout seen as (B, heads,
    S, hd): the strided views the LM hands the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda h: torch.randn(B, S, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)  # noqa: E731
    return make(H), make(Hkv), make(Hkv)


def _scan_operands(B, S, di, ds, x_dtype, seed=0):
    """Mamba-like scan operands: dt = softplus(N(-4, 1)) (the init's dt bias
    spans softplus^-1 of 1e-3..1e-1), A = -(1..ds) (S4D-real init), B, C, x
    ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device="cuda") - 4.0)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    Bm = torch.randn(B, S, ds, generator=g, device="cuda")
    Cm = torch.randn(B, S, ds, generator=g, device="cuda")
    x = torch.randn(B, S, di, generator=g, device="cuda").to(x_dtype)
    return dt, A, Bm, Cm, x


def phase_lm_kernels(device):
    """``flash_attention`` (bf16 and f32, causal, at the qwen3-4b prefill
    shape and at S 2047 and 37 < one tile) and
    ``selective_scan`` (x bf16 and f32, y and h_last, at the
    falcon-mamba-7b prefill shape and S 2047 and 37) against their plain
    versions; times at the full shapes (bf16 attention, bf16 x)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    fa = FA_SHAPE
    fa_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = FA_TOL[dtype]
        for S in (fa["S"], 2047, 37):
            q, k, v = _attention_operands(fa["B"], fa["H"], fa["Hkv"], S, fa["hd"], dtype)
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v)
            assert out.dtype == dtype and out.shape == ref.shape
            d = (out.float() - ref.float()).abs()
            excess = float((d - (atol + rtol * ref.float().abs())).max())
            err = float(d.max())
            print(f"flash_attention {str(dtype)[6:]} B={fa['B']} H={fa['H']}/{fa['Hkv']} S={S} hd={fa['hd']} "
                  f"causal: max |kernel - plain| = {err:.3e} (tol {atol} + {rtol:.3g} x |plain|)")
            assert excess <= 0.0, (dtype, S, err)
            if S == fa["S"] and dtype == torch.bfloat16:
                fa_err = err
    q, k, v = _attention_operands(fa["B"], fa["H"], fa["Hkv"], fa["S"], fa["hd"], torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    lib_err = float((sdpa().float() - flash_attention_ref(q, k, v).float()).abs().max())
    fns = {"ms": lambda: flash_attention(q, k, v), "plain_ms": lambda: flash_attention_ref(q, k, v),
           "library_ms": sdpa}
    for f in fns.values():
        f()
    timed = {name: _ms_median(f, 10 if name == "plain_ms" else 30, flush) for name, f in fns.items()}
    B, H, Hkv, S, hd = fa["B"], fa["H"], fa["Hkv"], fa["S"], fa["hd"]
    n_bytes = 2 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)  # q, o (H heads), k, v (Hkv), bf16
    n_flops = 2 * B * H * S * S * hd  # q k^T and p v over the causal triangle
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_BF16_FLOPS * 1e3
    fa_bound = max(t_bytes, t_ops)
    print(f"flash_attention timing (bf16, causal, median, L2 flushed, device time): kernel {timed['ms']:.4f} ms "
          f"({n_flops / timed['ms'] / 1e9:.1f} TFLOP/s), plain {timed['plain_ms']:.4f} ms, SDPA "
          f"{timed['library_ms']:.4f} ms (|SDPA - plain| {lib_err:.3e}); bound {fa_bound:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16)")
    rows = [{
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:74", "launches": None, "max_abs_err": fa_err,
        "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": fa_bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": timed["library_ms"],
    }]

    sc = SCAN_SHAPE
    scan_err = 0.0
    for x_dtype in (torch.bfloat16, torch.float32):
        for S in (sc["S"], 2047, 37):
            ops = _scan_operands(sc["B"], S, sc["di"], sc["ds"], x_dtype)
            y, h = selective_scan(*ops)
            torch.cuda.synchronize()
            y_ref, h_ref = selective_scan_ref(*ops)
            ey, eh = float((y - y_ref).abs().max()), float((h - h_ref).abs().max())
            ty = SCAN_TOL * max(1.0, float(y_ref.abs().max()))
            th = SCAN_TOL * max(1.0, float(h_ref.abs().max()))
            print(f"selective_scan x {str(x_dtype)[6:]} B={sc['B']} S={S} di={sc['di']} ds={sc['ds']}: "
                  f"max |kernel - plain| y {ey:.3e} (tol {ty:.2e}), h_last {eh:.3e} (tol {th:.2e})")
            assert ey <= ty and eh <= th, (x_dtype, S, ey, eh)
            if S == sc["S"] and x_dtype == torch.bfloat16:
                scan_err = max(ey, eh)
    ops = _scan_operands(sc["B"], sc["S"], sc["di"], sc["ds"], torch.bfloat16)
    fns = {"ms": lambda: selective_scan(*ops), "plain_ms": lambda: selective_scan_ref(*ops)}
    for f in fns.values():
        f()
    timed = {"ms": _ms_median(fns["ms"], 30, flush), "plain_ms": _ms_median(fns["plain_ms"], 3, flush)}
    B, S, di, ds = sc["B"], sc["S"], sc["di"], sc["ds"]
    # dt, y f32; x bf16; B, C f32; A, h_last f32
    n_bytes = 4 * B * S * di + 2 * B * S * di + 4 * B * S * di + 2 * 4 * B * S * ds + 4 * di * ds + 4 * B * di * ds
    n_exp = B * S * di * ds
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_exp / PEAK_EXP_PER_S * 1e3
    scan_bound = max(t_bytes, t_ops)
    print(f"selective_scan timing (x bf16, median, L2 flushed, device time): kernel {timed['ms']:.4f} ms, "
          f"plain {timed['plain_ms']:.4f} ms; no PyTorch call computes the scan; bound {scan_bound:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB; {n_exp / 1e9:.3f} G exp at {PEAK_EXP_PER_S / 1e12:.2f} T exp/s)")
    rows.append({
        "name": "selective_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:59", "launches": None, "max_abs_err": scan_err,
        "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": scan_bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
    })
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def phase_serve(device):
    """The serving entry point (``repro_torch.launch.serve``) at full width
    and depth: qwen3-4b, then falcon-mamba-7b, batch 4, prompt 2048, 32 new
    tokens, random weights made on the card.  Each with the launch counters
    set to 0 just before and read just after: one ``flash_attention`` per
    attention layer (36) or one ``selective_scan`` per Mamba layer (64) in
    the prefill, none in decode, no other kernel.  Returns the counts."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config

    counts = {}
    for arch, kernel in LM_SERVE:
        n_layers = get_config(arch).n_layers
        _reset_counters()
        r = serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "2048", "--max-new", "32", "--seed", "0"])
        c = _counters()
        print(f"serve {arch}: prefill {r['prefill_seconds']:.3f} s, decode {r['decode_seconds']:.3f} s "
              f"({r['decode_tok_per_s']:.1f} tok/s), init {r['init_seconds']:.2f} s, "
              f"peak memory {r['peak_memory_bytes'] / 1e9:.2f} GB; launches {c}")
        assert r["logits_finite"], arch
        assert r["launches"]["prefill"] == {k: (n_layers if k == kernel else 0) for k in serve.KERNELS}, r
        assert r["launches"]["decode"] == dict.fromkeys(serve.KERNELS, 0), r
        assert c[kernel] == n_layers and all(n == 0 for name, n in c.items() if name != kernel), c
        counts[kernel] = c[kernel]
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def phase_lm_cpu_vs_card(device):
    """The smoke LMs (f32) from the same weights and tokens on the CPU
    (plain versions) and the card (kernels), TF32 off: forward logits,
    prefill logits and caches, 4 teacher-forced decode steps and the caches
    after them, within LM_TOL."""
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import tree_map

    assert not torch.backends.cuda.matmul.allow_tf32  # main() keeps matmuls in full f32
    for arch, _ in LM_SERVE:
        bundle = get_bundle(arch + "-smoke")
        params = bundle.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(1, bundle.cfg.vocab, size=(2, 45)))
        out = {}
        for dev in (torch.device("cpu"), device):
            p, t = tree_map(lambda x: x.to(dev), params), tokens.to(dev)
            fwd = bundle.forward(p, {"tokens": t[:, :41]})
            logits, caches, pos = bundle.prefill(p, {"tokens": t[:, :41]}, 46)
            got = {"forward": fwd, "prefill": logits,
                   "prefill caches": torch.cat([c.reshape(-1) for cache in caches for c in cache.values()])}
            for i in range(4):
                logits, caches = bundle.decode_step(p, t[:, 41 + i : 42 + i], caches, pos + i)
                got[f"decode {i}"] = logits
            got["decode caches"] = torch.cat([c.reshape(-1) for cache in caches for c in cache.values()])
            out[dev.type] = {name: x.float().cpu() for name, x in got.items()}
        errs = {name: float((out["cpu"][name] - out["cuda"][name]).abs().max()) for name in out["cpu"]}
        print(f"cpu vs card, {arch}-smoke (f32, TF32 off): " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (tol {LM_TOL})")
        assert max(errs.values()) <= LM_TOL, errs



def _kernel_category(name):
    if "flash_attention_kernel" in name or "selective_scan_kernel" in name:
        return "port kernel"
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "Gemm")):
        return "cuBLAS matmul"
    if "copy" in name:
        return "copy / dtype cast"
    return "other elementwise and reductions"


def phase_serve_profile(device, decode_steps=8):
    """Where the serve path's device time goes.  For each LM at full size
    (batch 4, prompt 2048), one warm prefill, then ``torch.profiler`` over
    one prefill and over ``decode_steps`` greedy decode steps.  Counts device activities only (kernels, copies, sets; not
    the host-side "Command Buffer Full" marker): their time by category and
    the top 10 by name, and the device's busy share (the union of their
    intervals) of the host-clock window, which includes the profiler's own
    host cost, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models.registry import get_bundle

    for arch, _ in LM_SERVE:
        bundle = get_bundle(arch)
        params = bundle.init(torch.Generator(device=device).manual_seed(0))
        tokens = torch.from_numpy(serve.build_request_batch(bundle.cfg, 4, 2048, 0)).to(device)
        max_len = 2048 + decode_steps + 1
        with torch.inference_mode():
            bundle.prefill(params, {"tokens": tokens}, max_len)  # warm-up
            torch.cuda.synchronize()
            state = {}

            def run_prefill():
                state["logits"], state["caches"], state["pos"] = bundle.prefill(params, {"tokens": tokens}, max_len)

            def run_decode():
                logits, caches, pos = state["logits"], state["caches"], state["pos"]
                for i in range(decode_steps):
                    logits, caches = bundle.decode_step(params, logits[:, -1].argmax(-1, keepdim=True), caches,
                                                        pos + i)

            for stage, fn in (("prefill", run_prefill), (f"decode x{decode_steps}", run_decode)):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
                by_name, by_cat = {}, {}
                for name, t_start, t_end in spans:
                    n, ms = by_name.get(name, (0, 0.0))
                    by_name[name] = (n + 1, ms + (t_end - t_start) / 1e3)
                    cat = _kernel_category(name)
                    by_cat[cat] = by_cat.get(cat, 0.0) + (t_end - t_start) / 1e3
                busy_us, reach = 0.0, -math.inf
                for _, t_start, t_end in sorted(spans, key=lambda x: x[1]):
                    busy_us += max(0.0, t_end - max(t_start, reach))
                    reach = max(reach, t_end)
                dev_ms = sum(by_cat.values())
                print(f"profile {arch} {stage}: host-clock window {wall_ms:.1f} ms (profiled), device activities "
                      f"{len(spans)} taking {dev_ms:.1f} ms, busy {busy_us / 1e3:.1f} ms = "
                      f"{busy_us / 1e3 / wall_ms:.2f} of the window")
                for cat, ms in sorted(by_cat.items(), key=lambda x: -x[1]):
                    print(f"  {ms:9.2f} ms {100 * ms / max(dev_ms, 1e-9):5.1f}%  {cat}")
                for name, (n, ms) in sorted(by_name.items(), key=lambda x: -x[1][1])[:10]:
                    print(f"    {ms:9.2f} ms x{n:<5d} {name[:100]}")
        del params, state
        torch.cuda.empty_cache()


# -- slice 6: the kernel API, the per-slot and fused int8 combines, the tree oracle --------


def _main_path_mixing(layout, A_blocks):
    """The (L, K, K) mixing matrices behind ``_main_path_slab``'s blocks:
    each layer's first block."""
    first = torch.tensor([s // layout.lane for s, _ in layout.layer_slices], device=A_blocks.device)
    return A_blocks[first]


def _api_state(device):
    """The slice's operands on the main path's state: the K=16 width-16
    slab, its mixing (L, K, K) and the off-diagonal part, the int8 wire of
    the slab under one round's keys, and seeded uniforms for int8_quantize."""
    from repro_torch.comm import prng
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus

    layout, A_blocks, slab = _main_path_slab(device)
    K = slab.shape[0]
    A = _main_path_mixing(layout, A_blocks)
    A_off = A * (1.0 - torch.eye(K, device=device))
    keys = prng.fold_in(prng.fold_in(prng.key(0), 5), np.arange(K))
    wire, _ = consensus.slab_encode_batched(make_codec("int8"), layout, slab, (), keys)
    u = torch.rand(slab.shape, generator=torch.Generator(device=device).manual_seed(6), device=device)
    return layout, slab, A, A_off, wire, u


def _dequant_pieces(layout, A_off, wire):
    """The (weights, scales, int8 piece) operands of each ``dequant_combine``
    launch of ``dequant_combine_slab_per_slot``, in its order."""
    pieces = []
    for grp in layout.groups:
        for j in range(grp.n_slots):
            W = A_off[grp.layer0 + j].T.contiguous()
            base = grp.col0 + j * grp.s_pad
            for plan in grp.leaves:
                sid = plan.scale_seg0 + (j if plan.scale_per_slot else 0)
                c0 = base + plan.col0
                pieces.append((W, wire.s[:, sid].contiguous(), wire.q[:, c0 : c0 + plan.width]))
    return pieces


def phase_api_path(device):
    """The slice's path on the main path's state (K=16, ResNet-20 width 16,
    D=309,248, 2,416 blocks), with the counters set to 0 just before and
    read just after: ``combine_slab_per_slot`` (one ``weighted_combine``
    per layer slot), ``dequant_combine_slab_kernels`` (one
    ``slab_dequant_combine``), ``dequant_combine_slab_per_slot`` (one
    ``dequant_combine`` per slot and leaf), and ``int8_quantize`` then
    ``int8_dequantize`` on each layer segment.  Then, outside the counted
    run, each result against its whole-slab partner and its plain version.
    Returns the launch counts."""
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import consensus
    from repro_torch.kernels import quantize as qz

    layout, slab, A, A_off, wire, u = _api_state(device)
    L = layout.num_layers
    segs = [(slab[:, s:e].contiguous(), u[:, s:e].contiguous()) for s, e in layout.layer_slices]
    torch.cuda.synchronize()
    _reset_counters()
    per_slot = consensus.combine_slab_per_slot(layout, A, slab)
    fused = consensus.dequant_combine_slab_kernels(layout, A_off, wire)
    deq_slot = consensus.dequant_combine_slab_per_slot(layout, A_off, wire)
    quant = [qz.int8_quantize(x, uu) for x, uu in segs]
    dequant = [qz.int8_dequantize(q, s) for q, s in quant]
    torch.cuda.synchronize()
    c = _counters()
    want = {"weighted_combine": L, "slab_dequant_combine": 1,
            "dequant_combine": consensus.dequant_per_slot_launches(layout), "int8_quantize": L,
            "int8_dequantize": L}
    print(f"api path (K={slab.shape[0]} D={slab.shape[1]} L={L}): launches {c}; expected {want}")
    assert all(c[k] == v for k, v in want.items()), (c, want)
    assert all(v == 0 for k, v in c.items() if k not in want), c

    exact = consensus.combine_slab_kernels(layout, A, slab)
    e_slot = float((per_slot - exact).abs().max())
    decoded = consensus.slab_decode(make_codec("int8"), layout, wire)
    e_fused = float((fused - consensus.combine_slab_kernels(layout, A_off, decoded)).abs().max())
    e_deq = float((deq_slot - fused).abs().max())
    print(f"combine_slab_per_slot vs combine_slab_kernels: max |diff| {e_slot:.3e}; int8 wire: "
          f"dequant_combine_slab_kernels vs slab_combine of the decoded slab {e_fused:.3e}, "
          f"dequant_combine_slab_per_slot vs fused {e_deq:.3e} (tol {MAIN_TOL})")
    assert max(e_slot, e_fused, e_deq) <= MAIN_TOL, (e_slot, e_fused, e_deq)
    for out in (per_slot, fused, deq_slot):
        for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
            assert torch.all(out[:, s0 + size : e0] == 0), "lane padding must stay exactly zero"
    n_q = n_d = 0
    for (x, uu), (q, s), d in zip(segs, quant, dequant):
        assert torch.equal(s, qz.int8_scale(x))
        n_q += int((q != qz.int8_quantize_plain(x, uu, s)).sum())
        n_d += int((d != qz.int8_dequantize_plain(q, s)).sum())
    print(f"int8_quantize / int8_dequantize on the {L} layer segments: {n_q} / {n_d} values differ "
          f"from the plain versions")
    assert n_q == 0 and n_d == 0
    return {k: c[k] for k in want}


def phase_api_kernels(device):
    """The five kernels of slice 6 against their plain versions at the main
    path's shapes (every call ``phase_api_path`` makes) and at small ragged
    shapes (K = 3, 5, 64; widths that are not a multiple of the block; bf16
    sources for ``weighted_combine``, f32/bf16/f16 for ``int8_quantize``);
    then the times (median of 50, L2 flushed, device time) of the kernel,
    its plain version and, where one exists, the library call.  Returns the
    JSON entries (launches filled in later)."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.combine import weighted_combine, weighted_combine_ref
    from repro_torch.kernels.slab_combine import (
        MAX_AGENTS,
        launch_slab_dequant_combine,
        slab_dequant_combine,
        slab_dequant_combine_ref,
    )

    layout, slab, A, A_off, wire, u = _api_state(device)
    K, D = slab.shape
    L = layout.num_layers
    rng = np.random.default_rng(16)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    errs = dict.fromkeys(("weighted_combine", "dequant_combine", "int8_quantize", "int8_dequantize"), 0.0)
    slots = [(A[p].T.contiguous(), slab[:, s:e]) for p, (s, e) in enumerate(layout.layer_slices)]
    for W, x in slots:
        out = weighted_combine(W, x)
        torch.cuda.synchronize()
        errs["weighted_combine"] = max(errs["weighted_combine"], err(out, weighted_combine_ref(W, x)))
    pieces = _dequant_pieces(layout, A_off, wire)
    for W, s, q in pieces:
        out = qz.dequant_combine(W, s, q)
        torch.cuda.synchronize()
        errs["dequant_combine"] = max(errs["dequant_combine"], err(out, qz.dequant_combine_plain(W, s, q)))
    for p, (s0, e0) in enumerate(layout.layer_slices):
        x, uu = slab[:, s0:e0].contiguous(), u[:, s0:e0].contiguous()
        q, sc = qz.int8_quantize(x, uu)
        d = qz.int8_dequantize(q, sc)
        torch.cuda.synchronize()
        errs["int8_quantize"] = max(errs["int8_quantize"], err(q, qz.int8_quantize_plain(x, uu, sc)))
        errs["int8_dequantize"] = max(errs["int8_dequantize"], err(d, qz.int8_dequantize_plain(q, sc)))
    print(f"the {L} layer slots (weighted_combine, M = N = {K}, rows {D} apart), the {len(pieces)} "
          f"(slot, leaf) pieces (dequant_combine), int8_quantize / int8_dequantize per layer segment: "
          f"max |kernel - plain| {errs}")
    assert all(e == 0.0 for e in errs.values()), errs
    A_blocks = A_off[layout.block_layer_on(device)].contiguous()
    col_seg = layout.maps_on(device)["col_seg"]
    sdc = slab_dequant_combine(A_blocks, wire.s, col_seg, wire.q)
    torch.cuda.synchronize()
    e_sdc = float((sdc - slab_dequant_combine_ref(A_blocks, wire.s, col_seg, wire.q)).abs().max())
    print(f"slab_dequant_combine K={K} nb={layout.n_blocks}: max |kernel - plain| {e_sdc:.3e} (tol {MAIN_TOL})")
    assert e_sdc <= MAIN_TOL

    for M, N, n in [(3, 3, 129), (5, 5, 256 * 128 + 37), (MAX_AGENTS, MAX_AGENTS, 300), (1, 1, 1)]:
        W = t(rng.dirichlet(np.ones(N), size=M).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            x = t(rng.normal(size=(N, n)).astype(np.float32)).to(dt)
            out = weighted_combine(W, x)
            torch.cuda.synchronize()
            assert torch.equal(out, weighted_combine_ref(W, x)), (M, N, n, dt)
        s = t(rng.uniform(0.001, 0.02, N).astype(np.float32))
        q = t(rng.integers(-127, 128, size=(N, n)).astype(np.int8))
        out = qz.dequant_combine(W, s, q)
        torch.cuda.synchronize()
        assert torch.equal(out, qz.dequant_combine_plain(W, s, q)), (M, N, n)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = t(rng.normal(size=(M, n)).astype(np.float32)).to(dt)
            uu = t(rng.uniform(size=(M, n)).astype(np.float32))
            qq, ss = qz.int8_quantize(x, uu)
            dd = qz.int8_dequantize(qq, ss)
            torch.cuda.synchronize()
            assert torch.equal(qq, qz.int8_quantize_plain(x, uu, ss)), (M, n, dt)
            assert torch.equal(dd, qz.int8_dequantize_plain(qq, ss))
    for k, nb, n_segs in [(3, 1, 1), (5, 7, 4), (MAX_AGENTS, 3, 2)]:
        a = t(np.ascontiguousarray(rng.dirichlet(np.ones(k), size=(nb, k)).swapaxes(1, 2), np.float32))
        s = t(rng.uniform(0.001, 0.02, size=(k, n_segs)).astype(np.float32))
        seg = t(np.sort(rng.integers(0, n_segs, nb * 128)).astype(np.int32))
        q = rng.integers(-127, 128, size=(k, nb * 128)).astype(np.int8)
        q.reshape(k, nb, 128)[:, :, -3:] = 0
        q = t(q)
        out = slab_dequant_combine(a, s, seg, q)
        torch.cuda.synchronize()
        assert float((out - slab_dequant_combine_ref(a, s, seg, q)).abs().max()) <= MAIN_TOL, (k, nb)
        assert torch.all(out.view(k, nb, 128)[:, :, -3:] == 0)
    print("api kernels at small shapes (K = 3, 5, 64; ragged widths; f32, bf16, f16): weighted_combine, "
          "dequant_combine, int8_quantize, int8_dequantize bit for bit, slab_dequant_combine within tolerance")

    # times at the main path's shapes, over the whole slab as the path runs it.
    # int8_quantize's kernel is timed without the scale's torch reduction
    # (int8_round), slab_dequant_combine's without the wrapper's segment-id
    # check (a device sync): each bound counts the kernel's own bytes.
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    scale = qz.int8_scale(slab)
    q_all = qz.int8_quantize(slab, u)[0]
    s0 = wire.s[0, 0].contiguous()
    pieces_bytes = sum(4 * (W.numel() + s.numel()) for W, s, _ in pieces)
    runs = {  # name: (kernel, plain, library or None, bytes, operations)
        "weighted_combine": (
            lambda: [weighted_combine(W, x) for W, x in slots],
            lambda: [weighted_combine_ref(W, x) for W, x in slots],
            lambda: [torch.matmul(W, x) for W, x in slots],
            4 * (2 * K * D + L * K * K), 2 * K * K * D,
        ),
        "int8_quantize": (
            lambda: qz.int8_round(slab, u, scale),
            lambda: qz.int8_quantize_plain(slab, u, scale),
            None, 4 * K * D + 4 * K * D + K * D + 4, 2 * K * D,
        ),
        "int8_dequantize": (
            lambda: qz.int8_dequantize(q_all, s0),
            lambda: qz.int8_dequantize_plain(q_all, s0),
            lambda: q_all * s0, K * D + 4 * K * D + 4, K * D,
        ),
        "dequant_combine": (
            lambda: [qz.dequant_combine(W, s, q) for W, s, q in pieces],
            lambda: [qz.dequant_combine_plain(W, s, q) for W, s, q in pieces],
            None, K * D + 4 * K * D + pieces_bytes, 2 * K * K * D,
        ),
        "slab_dequant_combine": (
            lambda: launch_slab_dequant_combine(A_blocks, wire.s, col_seg, wire.q),
            lambda: slab_dequant_combine_ref(A_blocks, wire.s, col_seg, wire.q),
            None, K * D + 4 * D + 4 * (A_blocks.numel() + wire.s.numel()) + 4 * K * D, 2 * K * K * D + K * D,
        ),
    }
    lib_name = {"weighted_combine": f"torch.matmul x{L}", "int8_dequantize": "q * s"}
    source = {"weighted_combine": "combine.cu", "slab_dequant_combine": "slab_combine.cu"}
    replaces = {"weighted_combine": "combine.py:38", "int8_quantize": "quantize.py:69",
                "int8_dequantize": "quantize.py:111", "dequant_combine": "quantize.py:150",
                "slab_dequant_combine": "slab_combine.py:104"}
    entries = []
    for name, (fk, fp, fl, n_bytes, n_ops) in runs.items():
        for f in (fk, fp, fl):
            if f is not None:
                f()  # warm up
        ms = _ms_median(fk, 50, flush)
        issued = _ms_median(fk, 50, flush, queued=False)
        plain_ms = _ms_median(fp, 20, flush)
        lib_ms = _ms_median(fl, 50, flush) if fl is not None else None
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        lib = f", {lib_name[name]} {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"{name} timing (median, L2 flushed, device time): kernel {ms:.4f} ms ({issued:.4f} ms as "
              f"issued), plain {plain_ms:.4f} ms{lib}; bound {bound_ms:.4f} ms "
              f"({n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP, {bound_by}); "
              f"achieved {n_bytes / ms / 1e6:.0f} GB/s")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source.get(name, 'quantize.cu')}",
            "replaces": f"src/repro/kernels/{replaces[name]}", "launches": None,
            "max_abs_err": e_sdc if name == "slab_dequant_combine" else errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    return entries


def phase_tree_oracle(device, rounds=3):
    """The per-leaf tree oracle on the card at full width (K=16 ResNet-20
    width 16 agents drawn apart, GroupNorm untied; ring, 3 rounds): exact,
    int8, bf16, f16 and topk:0.1, DRT and classical, each against the slab
    path from the same weights.  Exact: parameters within MAIN_TOL, A to
    1e-4 relative (DRT's distances are differences of Gram entries,
    contracted each round), the disagreement to 1e-6 of mean_k ||x_k||^2
    (tests/test_torch_consensus.py's units).  A wire that rounds or
    thresholds (int8, bf16, f16, top-k): the two paths sum the Gram in
    another order, so after round 1 a value can round to its other
    neighbour (or cross top-k's threshold); each flip moves one wire value
    by one step (int8: the scale; bf16, f16: 2^-8, 2^-11 of the power of
    two above the largest |x|; top-k: the entry, below twice that power)
    and later rounds mix it convexly: every difference at most ``rounds``
    steps, in at most 2% of the columns.  The tree path runs no kernel
    (plain PyTorch)."""
    from repro_torch.comm import prng
    from repro_torch.core import consensus
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import tree_leaves

    pK, part = _permute_agents(device)
    K = tree_leaves(pK)[0].shape[0]
    topo = ring(K)
    scale = sum(float(x.double().square().sum()) for x in tree_leaves(pK)) / K
    top = 2.0 ** math.ceil(math.log2(max(float(x.abs().max()) for x in tree_leaves(pK))))
    # a top-k flip sends (or holds back) one entry at the threshold, below 2 top
    steps = {"int8": 1.01 * top / 127.0, "bf16": top * 2.0**-8, "f16": top * 2.0**-11, "topk:0.1": 2 * top}
    _reset_counters()
    t0 = time.perf_counter()
    for codec in (None, "int8", "bf16", "f16", "topk:0.1"):
        for algo in ("drt", "classical"):
            kw = dict(rounds=rounds, algorithm=algo, metropolis=topo.metropolis(), codec=codec,
                      rng=prng.key(13), obs=ObsConfig())
            t1 = time.perf_counter()
            tree = consensus.gather_consensus_rounds(part, pK, topo.c_matrix(), DRTConfig(), path="tree", **kw)
            torch.cuda.synchronize()
            t_tree = time.perf_counter() - t1
            assert all(v == 0 for v in _counters().values()), "the tree path runs no kernel"
            slab = consensus.gather_consensus_rounds(part, pK, topo.c_matrix(), DRTConfig(), path="slab", **kw)
            _reset_counters()
            d = [(a - b).abs().reshape(K, -1) for a, b in zip(tree_leaves(tree[0]), tree_leaves(slab[0]))]
            err = max(float(x.max()) for x in d)
            cols = sum(int((x > MAIN_TOL).any(dim=0).sum()) for x in d)
            n_cols = sum(x.shape[1] for x in d)
            e_A = float(((tree[1] - slab[1]).abs() / slab[1].abs().clamp(min=1e-2)).max())
            e_dis = float((tree[-1].disagreement - slab[-1].disagreement).abs().max()) / scale
            res = ""
            if codec == "topk:0.1":
                e_res = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(tree[2]), tree_leaves(slab[2])))
                res = f", residual max |diff| {e_res:.3e}"
                assert e_res <= rounds * steps[codec], e_res
            print(f"tree vs slab, {str(codec):8s} {algo:9s} K={K}, {rounds} rounds: max |out diff| "
                  f"{err:.3e}, columns beyond {MAIN_TOL}: {cols} of {n_cols}, max rel |A diff| {e_A:.3e}, "
                  f"disagreement diff {e_dis:.3e} x mean_k ||x_k||^2{res}; tree {t_tree:.2f} s")
            assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree[0]))
            assert float(tree[-1].disagreement[-1]) < float(tree[-1].disagreement[0])
            if codec in steps:
                assert err <= rounds * steps[codec] and cols <= 0.02 * n_cols, (codec, algo, err, cols)
            else:
                assert err <= MAIN_TOL, (codec, algo, err)
                assert e_A <= 1e-4 and e_dis <= 1e-6, (codec, algo, e_A, e_dis)
    print(f"tree oracle phase: {time.perf_counter() - t0:.1f} s")


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
    kernels = [phase_kernels(device), *phase_codec_kernels(device), *phase_edge_kernels(device),
               *phase_permute_kernels(device), *phase_lm_kernels(device), *phase_api_kernels(device)]
    launches = phase_main_path(device)
    launches.update(phase_api_path(device))
    phase_tree_oracle(device)
    launches.update(phase_serve(device))
    phase_serve_profile(device)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, k
    assert sorted(k["name"] for k in kernels) == sorted(_wrappers()), "one entry per kernel"
    phase_cpu_vs_card(device)
    phase_permute_cpu_vs_card(device)
    phase_lm_cpu_vs_card(device)
    print(f"chip_smoke phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
