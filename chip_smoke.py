"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (every failure raises; nothing is caught):
1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   both TF32 switches;
2. build every kernel of the main paths from ``src/repro_torch/kernels/csrc``
   (``slab_combine``, ``slab_codec``, ``slab_segment``, ``drt_dist``,
   ``flash_attention``, ``flash_attention_bwd``, ``selective_scan``,
   ``combine`` and ``quantize``: one nvcc per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at small odd shapes, and time kernel, plain
   version and, where one exists, one PyTorch library call of the same
   function (CUDA events, L2 flushed before each call, a device sleep first
   so the events see device time only; median):
   ``slab_combine`` (the main shape; K = 3, 16, 64 at 1, 3 and 2,417
   blocks, ``torch.einsum`` timed beside at 2,417; the main shape again
   after a read-only flush, beside a copy of the slab); ``slab_quant_encode``
   (bit for bit with the plain version on the card and the CPU at K =
   1..16, 17 and 64 by nb = 1, 3, 7, and on the main slab at K = 16 and at
   K = 1, one rank's slab as the permute engine encodes it; timed at both
   beside a cast of the slab to int8; the instructions of its SASS fast
   path counted); ``slab_encode_combine`` for every wire mode x algorithm
   (out and A within f32 tolerances, two runs bit-identical; a DRT round
   printed launch by launch, ``torch.profiler``);
   ``slab_edge_encode_combine`` for every wire mode x algorithm on the ring
   and the hypercube and ``slab_edge_combine`` (the edge path's kernels:
   out and the edge factors within f32 tolerances, the combine bit for bit
   with the plain one given the kernel's factors, two runs bit-identical,
   destination halves joined equal to the whole; a DRT round launch by
   launch), also at K=3, 5, 64 on a padded churn edge list with an
   isolated agent; the permute engine's
   ``drt_dist`` (every layer slot of the width-16 slab in one launch, slots
   of 1, 127, 129, 2049 and 10241 columns, one-slot sizes 1, 127, 129,
   10^6+3: relative 1e-5 of each sum, two runs bit-identical, one launch a
   call) and ``slab_source_combine`` (stacked and as separate rows, the
   main shape at N = 3, 5 and the Erdos-Renyi N, N = 1..7, 9 and 64 at odd
   widths: bit for bit; a source off a 16-byte boundary raises; timed in
   both forms beside the engine's old route, torch.stack then the kernel,
   torch.einsum and a 4-byte fill); the
   LM kernels: ``flash_attention`` at the qwen3-4b prefill shape (B 4, 32
   query heads over 8 KV heads, S 2048, hd 128) in bf16 (its tensor-core
   kernel: rtol 2^-7 plus atol 2^-8 max|v|, SDPA's own distance printed
   beside) and f32 (its CUDA-core kernel, 1e-5), at S 2047 and 37 (one
   partial tile), causal as the decoder's prefill, timed beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls), the
   flash_attention and slab_combine libraries' SASS checked for ``HGMMA``
   and ``UTMALDG`` (``cuobjdump``) and ptxas's report for no spills in
   them, ``selective_scan`` and ``drt_dist``, and ``selective_scan`` at the
   falcon-mamba-7b prefill shape (B 4, S 2048, di 8192, ds 16) with x bf16
   and f32, y and h_last, at S 2047 and 37, two runs bit-identical, timed
   at each lane count the kernel takes (B 4, 2 and 1), its SASS checked for
   ``MUFU.EX2``, ``SHFL.BFLY`` and ``LDGSTS`` and its unrolled tile's
   instructions per state-step printed; no spills (ptxas) in those
   kernels, ``drt_dist`` and the consensus rounds' stats, combine and
   Metropolis kernels; the
   kernel API's kernels on the K=16 width-16 slab, every call of its path:
   ``weighted_combine`` (one launch over the 11 layer slots, and the 11
   slots as single calls), ``dequant_combine`` (one launch over the 68 slot
   and leaf pieces, and the 68 single calls), ``int8_quantize`` /
   ``int8_dequantize`` bit for bit, ``slab_dequant_combine`` within
   MAIN_TOL (the (L, K, K) stack through the block map bit for bit with
   the per-block matrices), and at K = 1, 3, 5, 16, 64 with ragged widths,
   scale tables too large for shared memory and bf16 / f16 inputs;
   ``int8_quantize`` at lengths 1, 15, 16, 17, 4099, on views off a
   16-byte boundary and at the clip, ``int8_dequantize`` at the same
   lengths and offsets (one launch a call) and on the whole slab, all bit
   for bit; the two also behind a read-only L2
   flush beside a fill and a copy, ``int8_quantize``'s whole call and
   ``dequant_combine_slab_kernels`` timed beside them; ``int8_dequantize``
   behind both flushes beside a fill of its output and ``q * s``; the SASS
   of the three checked
   (``LDG.E.128`` / ``STG.E.128``; under one shared-memory load per four
   ``FFMA``) and ptxas's report for no spills in them;
   the two combines over unaligned, ragged segments with odd row strides
   bit for bit; each one-launch per-slot combine timed beside the old
   per-piece route, 11 ``torch.matmul`` s, ``torch.einsum`` and single calls
   at the largest and smallest slot and piece (it must beat its old route),
   and the instructions per product of their SASS;
4. drive the main paths through ``repro_torch.experiment``: the paper's
   configuration (K=16 agents, ResNet-20 width 16, 32x32 images, batch 128),
   ring.  The exact path (slice 1): two DRT epochs and one classical epoch.
   The coded path: int8 with two DRT epochs and one classical epoch, then
   one DRT epoch each with bf16, f16 and topk:0.1, each round one
   ``slab_encode_combine`` call of ``LAUNCHES_PER_CALL`` launches (two a
   DRT round; it launches no ``slab_quant_encode``).  A checkpoint: the
   state after one more exact DRT epoch saved (``repro_torch.ckpt``) and
   restored on the card bit for bit, a round-set from each bit for bit.
   The wire-encode path: the int8 wire of the
   main path's slab for three rounds' keys through
   ``consensus.slab_encode_batched``.  Each path runs with the launch
   counters set to 0 just before and read just after.  The edge path
   (``--consensus-path edge``): on the ring two exact DRT epochs, one exact
   classical epoch, two int8 DRT epochs and one DRT epoch each with bf16,
   f16 and topk:0.1; one exact DRT epoch each on Erdos-Renyi and the
   hypercube; every round is one ``slab_edge_encode_combine`` call of
   ``LAUNCHES_PER_CALL`` launches (two), an int8 round also one
   ``slab_quant_encode``, no dense kernel.  The scatter
   edge path: one exact DRT round-set at the main shape without CSR
   tables, through ``slab_edge_combine``.  The permute path
   (``PermuteConsensus`` through ``spmd_run``, 16 agents as 16 threads on
   the card, 3 rounds from K=16 width-16 agents drawn apart): on the ring
   DRT exact, int8, bf16 and topk:0.1 and classical exact, on Erdos-Renyi
   and the hypercube DRT exact; each against the gather engine on the same
   weights, its launches asserted to the engine's formulas (``drt_dist``
   rounds x exchanges per agent, one launch over all L layer slots of an
   exchange, one ``slab_source_combine`` per
   agent and round, int8 one ``slab_quant_encode`` per agent and round, no
   dense or edge kernel); then its ``path="tree"`` (per-leaf rounds, no
   kernel: the counters read 0) on the ring DRT exact, int8 and topk:0.1
   and classical exact, on Erdos-Renyi DRT exact, each against the slab
   path's result, host clock printed.  The LM serving path (``repro_torch.launch.serve``)
   at full width and depth, random weights made on the card: qwen3-4b, then
   falcon-mamba-7b, batch 4, prompt 2048, 32 new tokens; one
   ``flash_attention`` per attention layer (36, all on its tensor-core
   kernel) or one ``selective_scan`` per Mamba layer (64) in the prefill,
   none in decode, logits finite.  The
   kernel API path on the main path's slab: ``combine_slab_per_slot`` (1
   ``weighted_combine``), ``dequant_combine_slab_kernels`` (1
   ``slab_dequant_combine``), ``dequant_combine_slab_per_slot`` (1
   ``dequant_combine``), ``int8_quantize`` / ``int8_dequantize`` per layer
   segment (11 each), each against its whole-slab partner, each per-slot
   call's one kernel, and ``dequant_combine_slab_kernels``'s, its only
   device operation (``torch.profiler``); the tree oracle
   at full width (K=16, 3 rounds, ring, 5 codecs x 2 algorithms) against
   the slab path, no kernel launched on the tree path; dynamic graphs and
   round control (``phase_control``): the same K=16 width-16 agents over
   the reference's acceptance scenario (periodic ring/hypercube with 10%
   agent churn, seed 1: agent 0 isolated in round 0, agent 13 in round 1),
   momentum 0.4 and an adaptive budget whose tol gates round 2 off, on the
   gather engine exact (1 ``slab_combine``), int8 (2 ``slab_encode_combine``
   a round) and on the edge path (2 ``slab_edge_encode_combine`` a round),
   ``effective_rounds == 2``, and on the permute engine's slab path exact
   and int8 (``drt_dist`` per exchange of each round's decomposition,
   ``slab_source_combine`` a round) and tree path exact, each against the
   gather engine's tree oracle (or int8 slab path) with its launches
   asserted and its host seconds printed beside the card; Byzantine faults
   and trust-robust consensus (``phase_faults``): the Gauss attack's
   noise drawn on the card (bits equal to the CPU's, timed), the
   reference's K=16 ring scenario (25% sign-flip agents, the clustered
   two-layer stack, 8 rounds: Metropolis, DRT, DRT + trust_clip 0.15,
   trimmed mean, median), failing unless the honest drift gap exceeds 1
   and the Byzantine weight mass stays under 0.25, then a
   paper-configuration epoch under a 25% sign flip with DRT + trust_clip
   0.15, exact (1 ``slab_combine`` a round), int8 (also 1
   ``slab_quant_encode`` a round) and median (no kernel), each round-set
   against the same round-set on CPU tensors; consensus telemetry
   (``phase_telemetry``): every gather path and both permute paths at the
   paper's shape with ``obs`` on and off (outputs bit for bit, the same
   launches), each record field by field against the CPU's, the edge path
   under a 25% sign flip with DRT + trust_clip 0.15 (2 launches a round,
   the Byzantine mass equal to the slab path's), the records through the
   JSONL sink and back, a ``torch.profiler`` trace holding the five
   ``consensus.*`` spans, host seconds with ``obs`` on and off; then,
   outside the counted run, ``torch.profiler`` over one more prefill and 8
   decode steps of each: device time by kernel category and the device's
   busy share; decentralized LM training (``phase_lm_train``): the
   attention backward kernel ``flash_attention_bwd`` against its plain
   version in bf16 and f32 at the training shape (B 1, 32 query heads over
   8 KV heads, S 2048, hd 128) and at S 2047 and 37, given the forward
   kernel's own log-sum-exp (held to the plain one's), two runs
   bit-identical, three launches a call, timed beside its bound and SDPA's
   backward; three steps of ``make_train_step`` at qwen3-4b's full widths
   with 2 of its 36 layers, 4 agents on a ring, batch 1, sequence 2048,
   exact DRT on the slab, remat on: 16 ``flash_attention`` launches (all
   on the tensor-core kernel), 24 ``flash_attention_bwd`` launches and one
   ``slab_combine`` a step and nothing else, finite losses, step seconds,
   tokens/s and the peak memory (under 80 GB), then ``torch.profiler``
   over one more step; the train CLI (``python -m
   repro_torch.launch.train``) at qwen3-8b-smoke, K=4, seq 64, 2 steps,
   exact, int8 and on the edge path under a 25% sign flip with trust_clip
   0.15, on the card and on the CPU from the same weights: launches,
   losses, parameters and every JSONL field against the CPU's;
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

import collections
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


def _launch_breakdown(label, fn, flush, per_call, reps=20):
    """Each launch of one ``fn()`` call alone: ``torch.profiler`` over
    ``reps`` calls, each after ``flush()`` and a device sleep (the whole
    call queued), the port's kernels of a call in launch order.  Prints the
    median device ms of each launch over the calls the tracer saw whole
    (at least half), their sum, and the call's span from the first
    launch's start to the last one's end (the sum plus the gaps between
    dependent launches); returns ``(names, medians, span)``.

    A call is ``per_call`` launches of the same kernels in the same order.
    The tracer can miss a window's first launches, so a call seen short
    must be the tail of a whole one; a call with more launches, or other
    kernels, fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            torch.cuda._sleep(QUEUE_CYCLES)
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "_kernel" in e.name and "at::" not in e.name)
    # a call's launches follow each other within microseconds; calls are
    # milliseconds apart (flush, sleep)
    groups = []
    for sp in spans:
        if groups and sp[0] - groups[-1][-1][1] < 1000:  # us
            groups[-1].append(sp)
        else:
            groups.append([sp])
    lens = [len(g) for g in groups]
    assert len(groups) <= reps and max(lens) <= per_call, (label, lens, per_call, reps)
    calls = [g for g in groups if len(g) == per_call]
    assert len(calls) >= reps // 2, (label, lens, per_call, reps)

    def names_of(g):
        return [re.search(r"\w+_kernel(<[^>]*>)?", s[2]).group() for s in g]

    names = names_of(calls[0])
    for g in groups:  # every whole call the same kernels, every short one their tail
        assert names_of(g) == names[per_call - len(g) :], (label, names, names_of(g))
    med = [statistics.median((c[i][1] - c[i][0]) / 1e3 for c in calls) for i in range(per_call)]
    span = statistics.median((c[-1][1] - c[0][0]) / 1e3 for c in calls)
    parts = ", ".join(f"{nm} {ms:.4f}" for nm, ms in zip(names, med))
    print(f"{label} launch by launch (torch.profiler, median of {len(calls)} whole calls of {reps}, L2 flushed, "
          f"ms): {parts}; "
          f"sum {sum(med):.4f}, first start to last end {span:.4f}")
    return names, med, span


def phase_card():
    print(_card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")


def _kernel_name(mangled):
    """``name<template args>`` of a mangled kernel symbol: the nested name's
    parts (Itanium mangling: ``<length><identifier>`` after ``_ZN``) up to
    the one ending in ``_kernel``, and its template arguments: integers and
    bools (``L[ib]<n>E``), ``f`` (float), ``a`` (int8), ``i`` (int), ``l``
    (int64), named types
    (``<length><name>``) and a substitution (``S<n>_``) for the type named
    just before."""
    pos = mangled.find("_ZN") + 3
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        pos += m.end()
        ident = mangled[pos : pos + int(m.group())]
        pos += len(ident)
        if ident.endswith("_kernel"):
            if not mangled.startswith("I", pos):
                return ident
            args, pos = [], pos + 1
            while True:
                rest = mangled[pos:]
                if (m := re.match(r"L[ib](\d+)E", rest)) is not None:
                    arg, step = m.group(1), m.end()
                elif rest[:1] in ("f", "a", "i", "l"):
                    arg, step = {"f": "float", "a": "int8", "i": "int", "l": "int64"}[rest[0]], 1
                elif (m := re.match(r"\d+", rest)) is not None:
                    step = m.end() + int(m.group())
                    arg = rest[m.end() : step]
                elif args and (m := re.match(r"S\d*_", rest)) is not None:  # a type named before
                    arg, step = args[-1], m.end()
                else:
                    return f"{ident}<{','.join(args)}>"
                args.append(arg)
                pos += step
    return None


def phase_build():
    from repro_torch.kernels import build

    secs = build.build_all()
    print(f"built {list(build.KERNELS)} in {secs:.1f} s")
    for name, log in build.build_logs.items():
        # one line per kernel from ptxas's report: registers, spills, smem
        fn = None
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line.split()[-1])
            elif fn and "spill" in line:
                spill = line.strip()
            elif fn and "Used" in line:
                print(f"  nvcc[{name}] {fn}: {line.split(':', 1)[1].strip()}; {spill}")
                if fn.startswith(("flash_attention_bf16_kernel", "selective_scan_kernel", "drt_dist_kernel",
                                  "gram_stats", "combine_kernel", "edge_stats", "csr_combine_kernel",
                                  "metropolis_kernel", "quant_encode_kernel", "slab_source_combine_kernel",
                                  "combine_segments_kernel", "slab_dequant_combine_kernel",
                                  "int8_quantize_kernel", "int8_dequantize_kernel")):
                    assert spill.startswith("0 bytes stack frame, 0 bytes spill stores"), (fn, spill)
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

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    rng = np.random.default_rng(1)
    # ragged block counts at K = 3, 16, 64 (odd K: the A boxes start below
    # the block's matrix), and K = 4, 5 at small widths
    for k, n in [(k, n) for k in (3, 16, MAX_AGENTS) for n in (1, 3, 2417)] + [(4, 5), (5, 7)]:
        a = np.ascontiguousarray(rng.dirichlet(np.ones(k), size=(n, k)).swapaxes(1, 2), np.float32)
        x = rng.normal(size=(k, n * LANES)).astype(np.float32)
        x.reshape(k, n, LANES)[:, :, -3:] = 0.0
        a_t, x_t = torch.from_numpy(a).to(device), torch.from_numpy(x).to(device)
        before = slab_combine.launches
        o = slab_combine(a_t, x_t)
        torch.cuda.synchronize()
        assert slab_combine.launches == before + 1
        e_small = float((o - slab_combine_ref(a_t, x_t)).abs().max())
        timing = ""
        if n == 2417:
            x3 = x_t.view(k, n, LANES)
            ein = lambda: torch.einsum("blk,lbc->kbc", a_t, x3)  # noqa: E731
            ein()
            timing = (f"; kernel {_ms_median(lambda: slab_combine(a_t, x_t), 20, flush):.4f} ms, "
                      f"torch.einsum {_ms_median(ein, 20, flush):.4f} ms")
        print(f"slab_combine K={k} nb={n}: max |kernel - plain| = {e_small:.3e} (tol {MAIN_TOL}){timing}")
        assert e_small <= MAIN_TOL, (k, n, e_small)
        assert torch.all(o.view(k, n, LANES)[:, :, -3:] == 0)
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
    # the flush above leaves ~50 MB of dirty lines in L2 for the timed call
    # to write back; a read-only flush leaves them clean.  A copy of the slab
    # (the same bytes read and written, no mixing) beside it as a floor.
    ones = torch.ones(64 * 2**20, device=device)
    read_flush = ones.sum
    clean = {name: _ms_median(fns[name], 50, read_flush) for name in ("ms", "library_ms")}
    copy_ms = _ms_median(slab.clone, 50, read_flush)
    print(f"slab_combine timing with a read-only L2 flush: kernel {clean['ms']:.4f} ms, torch.einsum "
          f"{clean['library_ms']:.4f} ms, slab.clone() {copy_ms:.4f} ms ({8 * K * D / 1e6:.1f} MB)")
    del ones
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
    # K = 1: one rank's slab and round keys, as the permute engine encodes it
    slab1 = slab[:1]
    int8_ops1 = packing.int8_wire_operands(make_codec("int8"), layout, slab1, keys[:1])
    q1 = sc.slab_quant_encode(*int8_ops1, slab1)
    torch.cuda.synchronize()
    q1_cpu = sc.slab_quant_encode(*(t.cpu() for t in int8_ops1), slab1.cpu())
    assert torch.equal(q1, sc.slab_quant_encode_ref(*int8_ops1, slab1)) and torch.equal(q1.cpu(), q1_cpu)
    assert torch.equal(q1, q[:1]), "agent 0's wire depends on its own keys only"
    print(f"slab_quant_encode K=1 nb={nb} (the permute engine's shape): bit-exact with the plain version on "
          f"the card and the CPU's")
    small_k = list(range(1, 17)) + [17, sc.MAX_AGENTS]
    for k in small_k:
        for n in (1, 3, 7):
            x, ops, _, _, _ = _codec_operands(k, n, seed=k * 100 + n)
            qs = sc.slab_quant_encode(*ops, x)
            torch.cuda.synchronize()
            assert torch.equal(qs, sc.slab_quant_encode_ref(*ops, x)), (k, n)
            assert torch.equal(qs.cpu(), sc.slab_quant_encode(*(t.cpu() for t in ops), x.cpu())), (k, n)
    print(f"slab_quant_encode K={small_k} at nb=1, 3, 7: bit-exact with the plain version on the card and "
          f"the CPU's")

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
    # a DRT round launch by launch (int8: launch 1 stores the wire that
    # launch 2 reads; the classical int8 round's one launch hashes it)
    for mode in ("int8", "bf16"):
        kw = dict(mode=mode, algorithm="drt", num_layers=L, N_clip=2.0 * K)
        _launch_breakdown(f"slab_encode_combine drt {mode}",
                          lambda: sc.slab_encode_combine(bl, slab, ops_of[mode], mixes["drt"], **kw), flush,
                          sc.LAUNCHES_PER_CALL["drt"])
    one = torch.empty(1, device=device)
    fill_ms = _ms_median(one.zero_, 50, flush)  # one launch that moves 4 bytes, timed the same way
    q_timed = {}
    for k, ops, x in ((K, int8_ops, slab), (1, int8_ops1, slab1)):
        fk = lambda: sc.slab_quant_encode(*ops, x)  # noqa: E731
        fp = lambda: sc.slab_quant_encode_ref(*ops, x)  # noqa: E731
        fk(), fp()
        k_ms, k_plain_ms = _ms_median(fk, 50, flush), _ms_median(fp, 10, flush)
        k_issued = _ms_median(fk, 50, flush, queued=False)
        k_small = 4 * (ops[0].numel() + ops[4].numel() + ops[5].numel())
        k_bytes = 4 * k * D + maps_bytes + k_small + k * D
        k_bound, k_by = _bound(k_bytes, 4 * k * D)
        q_timed[k] = (k_ms, k_plain_ms, k_bound, k_by)
        print(f"slab_quant_encode timing K={k} nb={nb} (median, L2 flushed, device time): kernel {k_ms:.4f} ms "
              f"({k_issued:.4f} ms as issued), plain {k_plain_ms:.4f} ms, bound {k_bound:.5f} ms "
              f"({k_bytes / 1e6:.2f} MB, {k_by}); a 4-byte fill timed the same way {fill_ms:.4f} ms")
    cast_ms = _ms_median(lambda: slab.to(torch.int8), 50, flush)
    print(f"  beside it: slab.to(torch.int8), the same slab bytes in and out with no column maps and no hash, "
          f"{cast_ms:.4f} ms at K={K}")
    maps = layout.maps_on(device)
    seg4, leaf4 = maps["col_seg"].view(-1, 4), maps["col_leaf"].view(-1, 4)
    mixed = int(((seg4 != seg4[:, :1]) | (leaf4 != leaf4[:, :1])).any(1).sum())
    print(f"  four-column groups whose columns differ in scale segment or leaf: {mixed} of {D // 4}")
    q_ms, q_plain_ms, q_bound, q_by = q_timed[K]
    _quant_sass_report()
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
    for mode in ("exact", "int8"):
        kw = dict(mode=mode, algorithm="drt", num_layers=L, N_clip=2.0 * K)
        _launch_breakdown(f"slab_edge_encode_combine ring drt {mode}",
                          lambda: ss.slab_edge_encode_combine(bl, slab, wires[mode], *edges, *csr, **kw), flush,
                          ss.LAUNCHES_PER_CALL["drt"])
    dec = _int8_decoded(layout, wires["int8"])
    _launch_breakdown("slab_edge_combine ring drt", lambda: ss.slab_edge_combine(
        bl, slab, dec, *edges, algorithm="drt", num_layers=L, N_clip=2.0 * K), flush, ss.LAUNCHES_PER_CALL["drt"])
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
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    return {
        "flash_attention": flash_attention,
        "flash_attention_bwd": flash_attention_bwd,
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
        for attr in ("calls", "tc_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def _counters():
    """Every wrapper's launches, plus ``<name>_calls`` where one call makes
    several launches and ``flash_attention_tc``, the tensor-core kernel's
    share of ``flash_attention``'s launches."""
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        if hasattr(fn, "calls"):
            out[name + "_calls"] = fn.calls
        if hasattr(fn, "tc_launches"):
            out[name + "_tc"] = fn.tc_launches
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
    phase_checkpoint(args, shards, device)

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


def phase_checkpoint(args, shards, device):
    """The main path's train state after one exact DRT epoch (the trainer
    ``repro_torch.experiment`` builds, ring), saved with
    ``repro_torch.ckpt.save_train_state`` into a temporary directory and
    restored on the card: every leaf bit for bit and on the card; then one
    consensus round-set from the live state and from the restored one (a
    fresh trainer), bit for bit."""
    import tempfile

    from repro_torch import experiment
    from repro_torch.ckpt import restore_train_state, save_train_state
    from repro_torch.core.decentralized import DecentralizedState
    from repro_torch.data.cifar_like import agent_minibatches
    from repro_torch.utils.pytree import tree_items

    args.codec, args.epochs = None, 1
    topo = experiment.topology_for("ring", args.agents)
    tr = experiment.build_trainer(args, topo, "drt", device)
    st, _ = tr.epoch(tr.init(torch.Generator().manual_seed(0)), agent_minibatches(shards, batch_size=args.batch,
                                                                                  epoch_seed=0))
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_state(d, st)
        t1 = time.perf_counter()
        tree, step = restore_train_state(d, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    n = 0
    for key in ("params", "opt_state"):
        mine, theirs = list(tree_items(tree[key])), list(tree_items(getattr(st, key)))
        assert [p for p, _ in mine] == [p for p, _ in theirs], key
        for (p, a), (_, b) in zip(mine, theirs):
            assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), (key, p)
            n += a.numel()
    assert step == st.step == int(tree["step"]) and tree["comm"] == () == st.comm
    tr2 = experiment.build_trainer(args, topo, "drt", device)
    tr2.build_partition(tree["params"])
    live = tr.consensus(st)[0].params
    resumed = tr2.consensus(DecentralizedState(tree["params"], tree["opt_state"], step, tree["comm"]))[0].params
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(live), tree_items(resumed)))
    print(f"checkpoint of the main path's state after an exact DRT epoch (step {step}): {n} values "
          f"({size / 1e6:.1f} MB npz) saved in {t1 - t0:.2f} s, restored on {device} in {t2 - t1:.2f} s, "
          "bit for bit; a consensus round-set from it bit for bit with the live state's")


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
    permute path's shapes (every layer slot of the width-16 slab in one
    launch; the main shape with N = 3 ring, 5 hypercube, 7 Erdos-Renyi
    sources) and at small odd shapes; timings and bounds.  Returns the two
    JSON entries."""
    from repro_torch.core.consensus import exchange_decomposition
    from repro_torch.core.topology import PAPER_ER_SEED, erdos_renyi
    from repro_torch.kernels import drt_dist as dd
    from repro_torch.kernels.slab_combine import (
        LANES, MAX_SOURCES, slab_source_combine, slab_source_combine_ref,
    )

    layout, _, slab = _main_path_slab(device)
    K, D = slab.shape
    nb = layout.n_blocks

    def check_dist(run, ref, label):
        before = dd.drt_dist.launches
        got, again = run(), run()
        torch.cuda.synchronize()
        assert dd.drt_dist.launches == before + 2 * dd.LAUNCHES_PER_CALL, label
        assert torch.equal(got, again), ("not bit-reproducible", label)
        want = ref()
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        assert rel <= DIST_RTOL, (label, rel)
        return rel, float((got - want).abs().max())

    # the permute engine's call: every layer slot of one exchange in one launch
    slots = layout.slot_table_on(device)
    x, y = slab[0].contiguous(), slab[1].contiguous()
    worst, worst_abs = check_dist(lambda: dd.drt_dist_slots(x, y, slots),
                                  lambda: dd.drt_dist_slots_ref(x, y, slots), "slots")
    print(f"drt_dist_slots on the {layout.num_layers} layer slots of the K={K} width-16 slab "
          f"(sizes {[e - s for s, e in layout.layer_slices]}, {slots.chunks.shape[0]} chunks): max relative "
          f"|kernel - plain| {worst:.3e} (tol {DIST_RTOL}; absolute {worst_abs:.3e}), two runs identical, "
          f"{dd.LAUNCHES_PER_CALL} launch a call")
    rng = np.random.default_rng(2)
    odd = dd.slot_table([(0, 1), (1, 128), (128, 257), (300, 2349), (2349, 2349 + 5 * dd.CHUNK + 1)], device)
    xo, yo = (torch.from_numpy(a).to(device) for a in rng.normal(size=(2, 2349 + 5 * dd.CHUNK + 1)).astype(np.float32))
    check_dist(lambda: dd.drt_dist_slots(xo, yo, odd), lambda: dd.drt_dist_slots_ref(xo, yo, odd), "odd slots")
    for n in (1, 127, 129, 1_000_003):
        xn, yn = (torch.from_numpy(a).to(device) for a in rng.normal(size=(2, n)).astype(np.float32))
        check_dist(lambda: dd.drt_dist(xn, yn), lambda: dd.drt_dist_ref(xn, yn), n)
    print("drt_dist_slots at slots of 1, 127, 129, 2049 and 10241 columns, drt_dist at sizes 1, 127, 129, "
          "1000003: within tolerance, two runs identical, one launch a call")
    n_er = 1 + len(exchange_decomposition(erdos_renyi(K, 0.1, PAPER_ER_SEED)))
    # both forms: a stacked (N, D) tensor, and N separately allocated rows
    # (the permute engine's own slab and the received ones, no stack)
    srcs_of = {}
    cases = [(3, nb), (5, nb), (n_er, nb)] + [(n, 2 * n + 1) for n in range(1, 8)] + [(9, 5), (MAX_SOURCES, 13)]
    for N, n_blk in cases:
        w = torch.from_numpy(rng.dirichlet(np.ones(N), size=n_blk).astype(np.float32)).to(device)
        srcs = (slab[:N] if n_blk == nb and N <= K else
                torch.from_numpy(rng.normal(size=(N, n_blk * LANES)).astype(np.float32)).to(device))
        srcs = srcs.contiguous()
        rows = [srcs[n].clone() for n in range(N)]
        before = slab_source_combine.launches
        out, out_rows = slab_source_combine(w, srcs), slab_source_combine(w, rows)
        torch.cuda.synchronize()
        assert slab_source_combine.launches == before + 2
        want = slab_source_combine_ref(w, srcs)
        assert torch.equal(out, want) and torch.equal(out_rows, want), (N, n_blk)
        srcs_of[N, n_blk] = (w, srcs, rows)
    print(f"slab_source_combine N=3, 5, {n_er} at nb={nb}, N=1..7 at nb=3..15, N=9 (nb=5), {MAX_SOURCES} "
          f"(nb=13), stacked and as separate rows: bit-identical with the plain version")
    w3, _, rows3 = srcs_of[3, nb]
    unaligned = torch.zeros(D + 1, device=device)[1:]
    before = slab_source_combine.launches
    for bad in ([rows3[0], rows3[1], unaligned], torch.zeros(3 * D + 1, device=device)[1:].view(3, D)):
        try:
            slab_source_combine(w3, bad)
        except ValueError as e:
            assert "16-byte aligned" in str(e), e
        else:
            raise AssertionError("slab_source_combine took a source 4 bytes off a 16-byte boundary")
    assert slab_source_combine.launches == before
    print("slab_source_combine: a source 4 bytes off a 16-byte boundary raises ValueError, in either form, "
          "before any launch")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    # drt_dist: one exchange's statistics, the call the engine makes; beside
    # it the L one-slot calls, each one launch, that the engine made before
    pairs = [(x[s:e], y[s:e]) for s, e in layout.layer_slices]
    fk = lambda: dd.drt_dist_slots(x, y, slots)  # noqa: E731
    fl = lambda: [dd.drt_dist(a, b) for a, b in pairs]  # noqa: E731
    fp = lambda: dd.drt_dist_slots_ref(x, y, slots)  # noqa: E731
    fk(), fl(), fp()
    d_ms, d_plain, d_slotwise = _ms_median(fk, 50, flush), _ms_median(fp, 20, flush), _ms_median(fl, 50, flush)
    d_issued, d_slotwise_issued = _ms_median(fk, 50, flush, queued=False), _ms_median(fl, 50, flush, queued=False)
    d_bound, d_by = _bound(2 * 4 * D + 4 * 2 * layout.num_layers, 5 * D)
    one = torch.empty(1, device=device)
    floor_ms = _ms_median(one.zero_, 50, flush)  # one launch that moves 4 bytes, timed the same way
    print(f"drt_dist timing, one exchange's {layout.num_layers} slots in one launch (median, L2 flushed, device "
          f"time): kernel {d_ms:.4f} ms ({d_issued:.4f} ms as issued), plain {d_plain:.4f} ms, bound "
          f"{d_bound:.5f} ms ({2 * 4 * D / 1e6:.2f} MB, {d_by}); {layout.num_layers} one-slot calls "
          f"{d_slotwise:.4f} ms ({d_slotwise_issued:.4f} ms as issued); a 4-byte fill timed the same way "
          f"{floor_ms:.4f} ms; no single torch call returns both sums")
    timed = {}
    for N in (3, 5, n_er):
        w, srcs, rows = srcs_of[N, nb]
        x3 = srcs.view(N, nb, LANES)
        fk = lambda: slab_source_combine(w, rows)  # noqa: E731
        fs = lambda: slab_source_combine(w, srcs)  # noqa: E731
        fo = lambda: slab_source_combine(w, torch.stack(rows))  # noqa: E731  (the engine's route before)
        fp = lambda: slab_source_combine_ref(w, rows)  # noqa: E731
        fl = lambda: torch.einsum("bn,nbl->bl", w, x3)  # noqa: E731
        lib_err = float((fl().reshape(-1) - slab_source_combine_ref(w, srcs)).abs().max())
        assert lib_err <= MAIN_TOL, lib_err
        fk(), fs(), fo(), fp(), fl()
        ms, stacked_ms, old_ms = _ms_median(fk, 50, flush), _ms_median(fs, 50, flush), _ms_median(fo, 50, flush)
        plain_ms, lib_ms = _ms_median(fp, 20, flush), _ms_median(fl, 50, flush)
        old_again, ms_again = _ms_median(fo, 50, flush), _ms_median(fk, 50, flush)
        n_bytes = 4 * N * D + 4 * D + 4 * nb * N
        bound_ms, bound_by = _bound(n_bytes, 2 * N * D)
        timed[N] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        print(f"slab_source_combine timing N={N} nb={nb} (median, L2 flushed, device time): kernel on separate "
              f"rows {ms:.4f} ms (again {ms_again:.4f}), on a stacked tensor {stacked_ms:.4f} ms; the engine's "
              f"old route torch.stack + kernel {old_ms:.4f} ms (again {old_again:.4f}); plain {plain_ms:.4f} ms, "
              f"torch.einsum {lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB, {bound_by}); "
              f"a 4-byte fill {floor_ms:.4f} ms")
    # a flush that leaves L2 clean: the timed call then has no dirty lines to write back
    ones = torch.ones(64 * 2**20, device=device)
    w, _, rows = srcs_of[3, nb]
    clean_ms = _ms_median(lambda: slab_source_combine(w, rows), 50, ones.sum)
    clean_old = _ms_median(lambda: slab_source_combine(w, torch.stack(rows)), 50, ones.sum)
    print(f"slab_source_combine N=3 with a read-only L2 flush: kernel {clean_ms:.4f} ms, torch.stack + kernel "
          f"{clean_old:.4f} ms, a 4-byte fill {_ms_median(one.zero_, 50, ones.sum):.4f} ms")
    del ones
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
    from repro_torch.device import synchronize
    from repro_torch.utils.pytree import tree_leaves, tree_map

    def body(rank, ex):
        if sent is not None:
            ex = _Recording(ex, sent)
        out = eng(tree_map(lambda x: x[rank], pK), ex, rng=rng, rounds=rounds)
        return out[0] if codec else out

    device = tree_leaves(pK)[0].device
    synchronize(device)
    t0 = time.perf_counter()
    outs = spmd_run(body, K, device=device)
    synchronize(device)
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
    tree_cases = [("ring", "drt", None), ("ring", "drt", "int8"), ("ring", "drt", "topk:0.1"),
                  ("ring", "classical", None), ("erdos_renyi", "drt", None)]
    slab_out = {}
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
        if (name, algo, codec) in tree_cases:
            slab_out[name, algo, codec] = got
        want_calls = K * rounds * n_ex * (algo == "drt")  # one per exchange over all L slots
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
    phase_permute_tree(pK, part, K, slab_out, rounds, rng, steps)
    return totals


def phase_permute_tree(pK, part, K, slab_out, rounds, rng, steps):
    """The permute engine's ``path="tree"`` (per-leaf rounds, plain tensor
    ops on the card, no kernel) at the permute path's shape, each case
    against the slab path's result on the same weights and keys: exact at
    the engine tolerance, int8 and top-k by the wire-step rule; the launch
    counters read 0 after each case."""
    from repro_torch import PermuteConsensus
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import PAPER_ER_SEED, make_topology
    from repro_torch.utils.pytree import tree_items

    t_all = time.perf_counter()
    for (name, algo, codec), want in slab_out.items():
        topo = make_topology(name, K, **(dict(p=0.1, seed=PAPER_ER_SEED) if name == "erdos_renyi" else {}))
        eng = PermuteConsensus(part, topo, DRTConfig(), algorithm=algo, codec=codec, path="tree")
        _reset_counters()
        got, secs = _run_permute(eng, pK, K, rounds, rng if codec else None, codec)
        c = _counters()
        assert not any(c.values()), ("the tree path launched a kernel", c)
        for (_, a), (_, x) in zip(tree_items(got), tree_items(pK)):
            assert a.shape == x.shape and a.device == x.device and bool(torch.isfinite(a).all())
        if codec in steps:
            worst, n_bad, n_all = _wire_step_check(got, want, steps[codec], ("tree", name, codec))
            note = f"max |diff| {worst:.3e} (one wire step {steps[codec]:.3e}), {n_bad} of {n_all} beyond 2e-4/2e-5"
        else:
            worst = 0.0
            for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
                worst = max(worst, float((a - b).abs().max()))
            note = f"max |diff| {worst:.3e} (rtol 2e-4, atol 2e-5)"
        print(f"  permute tree {name:11s} {algo:9s} {str(codec):8s}: no kernel launched; vs the slab path "
              f"{note}; round-set {secs * 1e3:.1f} ms (host clock)")
    print(f"permute tree path: {len(slab_out)} cases in {time.perf_counter() - t_all:.1f} s")


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
# slice 14: dynamic graphs and round control
# ---------------------------------------------------------------------------

CONTROL_BETA = 0.4  # heavy-ball momentum of the reference's scenario matrix control row
# the exact paths against the gather engine's tree oracle: MAIN_TOL on the
# parameters; mixing weights to 1e-4 relative and the disagreement to 1e-6 of
# mean_k ||x_k||^2 (the Gram path's units, as the tree oracle phase)
CONTROL_A_RTOL, CONTROL_DIS_TOL = 1e-4, 1e-6


def _card_line():
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _quant_steps(rounds, beta):
    """What flipped int8 roundings can move an iterate after ``rounds``
    controlled rounds, in quantization steps: a flip moves one wire value by
    one step, mixing is convex, and e' <= (1 + beta) e + beta e_prev + 1."""
    e_prev, e = 0.0, 0.0
    for _ in range(rounds):
        e_prev, e = e, (1 + beta) * e + beta * e_prev + 1.0
    return e


def phase_control(device, rounds=3):
    """Dynamic graphs and round control at the paper's shape (K=16
    ResNet-20 width 16, agents drawn apart, GroupNorm untied) over the
    reference's acceptance scenario, ``ChurnSchedule(PeriodicSchedule((ring,
    hypercube)), agent_drop=0.1, seed=1)`` (agent 0 isolated in round 0,
    agent 13 in round 1), momentum 0.4 and ``adaptive:<tol>:3``, tol the
    geometric mean of the disagreements after rounds 1 and 2 of the fixed
    run (gather engine, exact): rounds 0 and 1 run, round 2 is gated off.

    Round-sets, each with the counters set to 0 just before and read just
    after: the gather engine exact (the Gram path: 1 ``slab_combine``),
    int8 (2 ``slab_encode_combine`` launches a round, gated or not) and on
    the edge path (2 ``slab_edge_encode_combine`` a round), each with
    ``effective_rounds == 2``; the permute engine's slab path exact and
    int8 (per rank one ``drt_dist`` per exchange of each round's own
    decomposition, one ``slab_source_combine`` a round, int8 one
    ``slab_quant_encode`` a round) and its tree path exact (no kernel).
    Exact ones against the gather engine's tree oracle (MAIN_TOL; the
    permute engine at its rtol 2e-4, atol 2e-5); int8 ones against the
    tree oracle's int8 round-set (the gather engine) or the gather engine's
    int8 slab path (the permute engine) in quantization steps.  The
    permute engine's gated round-set equals its 2-round set bit for bit.
    Prints each round-set's host seconds beside the card's name and power
    limit.  Returns the launch counts."""
    from repro_torch import PermuteConsensus
    from repro_torch.comm import prng
    from repro_torch.core import consensus, dynamic
    from repro_torch.core.consensus import exchange_decomposition
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import hypercube, ring
    from repro_torch.device import synchronize
    from repro_torch.kernels import drt_dist as dd
    from repro_torch.kernels import slab_codec, slab_segment
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import tree_items, tree_leaves

    card = _card_line() if device.type == "cuda" else "cpu"
    on_card = device.type == "cuda"
    K = 16
    pK, part = _permute_agents(device, K)
    sched = dynamic.ChurnSchedule(dynamic.PeriodicSchedule((ring(K), hypercube(K))), agent_drop=0.1, seed=1)
    iso = [[k for k in range(K) if not sched.topology_at(t).adjacency[k].any()] for t in range(rounds)]
    assert iso[0] == [0] and iso[1] == [13], iso
    n_ex = [len(exchange_decomposition(sched.topology_at(t))) for t in range(rounds)]
    assert all(n > 0 for n in n_ex), n_ex
    C, M = sched.mixing_stacks(0, rounds, device)
    edges, dmax = sched.edge_stacks(0, rounds, device), sched.max_in_degree
    rng = prng.key(17)
    scale = sum(float(x.double().square().sum()) for x in tree_leaves(pK)) / K
    top = 2.0 ** math.ceil(math.log2(max(float(x.abs().max()) for x in tree_leaves(pK))))
    int8_bound = _quant_steps(rounds, CONTROL_BETA) * 1.01 * top / 127.0

    def gather(path, codec=None, tol=None):
        kw = dict(rounds=rounds, metropolis=M, path=path, momentum=CONTROL_BETA, round_tol=tol, obs=ObsConfig())
        if codec:
            kw.update(codec=codec, rng=rng)
        if path == "edge":
            kw.update(edges=edges, max_in_degree=dmax)
        return consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), **kw)

    def permute(path, codec=None, tol=None, n_rounds=rounds):
        eng = PermuteConsensus(part, ring(K), DRTConfig(), codec=codec, path=path, schedule=sched,
                               momentum=CONTROL_BETA, round_tol=tol)
        return _run_permute(eng, pK, K, n_rounds, rng if codec else None, codec)[0]

    def counted(fn):
        _reset_counters()
        synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        return out, _counters(), time.perf_counter() - t0

    d = gather("slab")[-1].disagreement.double().cpu().numpy()
    assert d[0] > d[1] > d[2], d
    tol = float(np.sqrt(d[0] * d[1]))
    print(f"control phase ({card}): K={K} width 16, ChurnSchedule(PeriodicSchedule((ring, hypercube)), "
          f"agent_drop=0.1, seed=1): isolated {iso}, exchanges a round {n_ex}; momentum {CONTROL_BETA}, "
          f"adaptive:{tol}:{rounds} (fixed run's disagreements {d.tolist()})")
    oracle, c, secs = counted(lambda: gather("tree", tol=tol))
    assert not any(c.values()), c
    oracle8, c, secs8 = counted(lambda: gather("tree", "int8", tol))
    assert not any(c.values()), c
    for m in (oracle[-1], oracle8[-1]):
        assert m.effective_rounds.tolist() == [1.0, 2.0, 2.0], m.effective_rounds
    print(f"  gather tree oracle exact {secs:.3f} s, int8 {secs8:.3f} s (host clock, {card}); no kernel")

    def diffs(got, want):
        d_ = [(a - b).abs().reshape(K, -1) for a, b in zip(tree_leaves(got), tree_leaves(want))]
        return max(float(x.max()) for x in d_), sum(int((x > MAIN_TOL).any(dim=0).sum()) for x in d_), \
            sum(x.shape[1] for x in d_)

    zero = dict.fromkeys(_wrappers(), 0)
    totals = dict.fromkeys(("slab_combine", "slab_encode_combine", "slab_edge_encode_combine", "drt_dist",
                            "slab_source_combine", "slab_quant_encode"), 0)
    drt_calls = K * sum(n_ex)
    runs = [
        ("gather exact (Gram path)", lambda: gather("slab", tol=tol), oracle, dict(slab_combine=1)),
        ("gather int8", lambda: gather("slab", "int8", tol), oracle8,
         dict(slab_encode_combine=rounds * slab_codec.LAUNCHES_PER_CALL["drt"], slab_encode_combine_calls=rounds)),
        ("gather edge exact", lambda: gather("edge", tol=tol), oracle,
         dict(slab_edge_encode_combine=rounds * slab_segment.LAUNCHES_PER_CALL["drt"],
              slab_edge_encode_combine_calls=rounds)),
        ("permute slab exact", lambda: permute("slab", tol=tol), oracle,
         dict(drt_dist=drt_calls * dd.LAUNCHES_PER_CALL, slab_source_combine=K * rounds)),
        ("permute slab int8", lambda: permute("slab", "int8", tol), None,
         dict(drt_dist=drt_calls * dd.LAUNCHES_PER_CALL, slab_source_combine=K * rounds,
              slab_quant_encode=K * rounds)),
        ("permute tree exact", lambda: permute("tree", tol=tol), oracle, {}),
    ]
    outs = {}
    for label, fn, ref, launches in runs:
        out, c, secs = counted(fn)
        want = {k: on_card * v for k, v in dict(zero, **launches).items()}
        got_c = {k: c[k] for k in want}
        assert got_c == want, (label, got_c, want)
        for k in totals:
            totals[k] += c[k]
        tree = out[0] if label.startswith("gather") else out
        outs[label] = tree
        for (_, a), (_, x) in zip(tree_items(tree), tree_items(pK)):
            assert a.shape == x.shape and a.device == x.device and bool(torch.isfinite(a).all()), label
        note = ""
        if label.startswith("gather"):
            m = out[-1]
            assert m.effective_rounds.tolist() == [1.0, 2.0, 2.0], (label, m.effective_rounds)
            e_dis = float((m.disagreement - ref[-1].disagreement).abs().max()) / scale
            e_A = float(((out[1] - ref[1]).abs() / ref[1].abs().clamp(min=1e-2)).max())
            note = f", effective_rounds {m.effective_rounds.tolist()}, max rel |A diff| {e_A:.3e}, " \
                   f"disagreement diff {e_dis:.3e} x mean_k ||x_k||^2"
            assert e_dis <= CONTROL_DIS_TOL, (label, e_dis)
            if "int8" not in label:
                assert e_A <= CONTROL_A_RTOL, (label, e_A)
        if label == "permute slab int8":
            worst, n_bad, n_all = _wire_step_check(out, outs["gather int8"], int8_bound, label)
            note += f" vs the gather engine's int8 slab path: {n_bad} of {n_all} beyond 2e-4/2e-5"
        elif "int8" in label:
            worst, cols, n_cols = diffs(tree, ref[0])
            assert worst <= int8_bound and cols <= 0.02 * n_cols, (label, worst, cols, n_cols)
            note += f", columns beyond {MAIN_TOL}: {cols} of {n_cols}"
        elif label.startswith("permute"):
            worst = 0.0
            for (_, a), (_, b) in zip(tree_items(tree), tree_items(ref[0])):
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
                worst = max(worst, float((a - b).abs().max()))
        else:
            worst, _, _ = diffs(tree, ref[0])
            assert worst <= MAIN_TOL, (label, worst)
        bound = int8_bound if "int8" in label else MAIN_TOL
        print(f"  {label}: launches {{{', '.join(f'{k} {v}' for k, v in got_c.items() if v)}}}; "
              f"max |diff| {worst:.3e} (bound {bound:.3e}){note}; round-set {secs:.3f} s (host clock, {card})")
    two = permute("slab", n_rounds=2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(outs["permute slab exact"]),
                                                          tree_items(two))), "the gated round changed the iterate"
    print("  permute slab exact: the gated round-set equals the 2-round set bit for bit")
    return totals


# ---------------------------------------------------------------------------
# slice 16: Byzantine faults and trust-robust consensus
# ---------------------------------------------------------------------------

BYZ_FRACTION, BYZ_CLIP, BYZ_ROUNDS = 0.25, 0.15, 8  # the reference's run_byzantine scenario


def _counted(fn, device):
    """``fn()`` with the counters set to 0 just before and read just after:
    ``(out, counters, host seconds to a device sync)``."""
    from repro_torch.device import synchronize

    _reset_counters()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, _counters(), time.perf_counter() - t0


def _check_launches(label, c, want, on_card):
    """Every wrapper's launches as ``want`` says (0 where it says nothing),
    all 0 off the card."""
    want = {k: on_card * v for k, v in dict(dict.fromkeys(_wrappers(), 0), **want).items()}
    got = {k: c[k] for k in want}
    assert got == want, (label, got, want)
    return {k: v for k, v in got.items() if v}


def _byzantine_scenario(device, card, on_card):
    """``combine_micro.run_byzantine`` on the port: the K=16 ring, 25% of the
    agents (seed 0) publish ``-x`` every round, the clustered two-layer
    stack ``{w: (32, 32), b: (128,)}`` (a base point plus 5% per-agent
    spread, numpy seed 0), 8 exact rounds: Metropolis, DRT, DRT +
    trust_clip 0.15, trimmed:0.25 and median.  Each cell's honest drift
    (mean squared distance of the honest agents to their initial mean) and
    mean Byzantine weight mass; fails unless Metropolis's drift over DRT +
    clip's exceeds 1 and DRT + clip's mass stays under 0.25 (the
    reference's gates, ``benchmarks/check_regression.py``).  A weighted
    cell is one ``slab_combine`` a round, a robust one none.  Each cell is
    held against the same round-set on CPU tensors, within MAIN_TOL or 8
    times the CPU round-set's own change when every input moves one ulp up,
    whichever is larger: the agents sit 5% apart, so DRT's distances are
    differences of Gram entries ~200 times larger, and the two devices'
    Grams sum in another order (on the CPU one ulp of input moves DRT's
    8-round result by ~5e-4, Metropolis's by ~4e-7)."""
    from repro_torch import faults
    from repro_torch.core import consensus
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_leaves, tree_map

    K = 16
    rng = np.random.default_rng(0)
    base = {"b": rng.normal(size=(128,)), "w": rng.normal(size=(32, 32))}
    noise = {"b": rng.normal(size=(K, 128)), "w": rng.normal(size=(K, 32, 32))}
    host = {k: (base[k][None] + 0.05 * noise[k]).astype(np.float32) for k in base}
    plan = faults.make_fault_plan(K, byzantine=BYZ_FRACTION, fault_model="sign_flip", seed=0)
    honest = np.flatnonzero(~plan.mask.mask_at(0))
    target = {k: v.astype(np.float64)[honest].mean(0) for k, v in host.items()}
    topo = ring(K)

    nudged = {k: np.nextafter(v, np.float32(np.inf)) for k, v in host.items()}

    def run(dev, algorithm="drt", start=host, **kw):
        pK = tree_map(lambda x: torch.from_numpy(x).to(dev), start)
        part = LayerPartition.build(agent_template(pK))
        return consensus.gather_consensus_rounds(
            part, pK, topo.c_matrix(), DRTConfig(), rounds=BYZ_ROUNDS, algorithm=algorithm,
            metropolis=topo.metropolis(), faults=plan.realize(0, BYZ_ROUNDS, dev), obs=ObsConfig(), **kw)

    def drift(out):
        return sum(float(((v.double().cpu().numpy()[honest] - target[k][None]) ** 2).sum())
                   for k, v in out.items()) / len(honest)

    cells = [("metropolis", dict(algorithm="classical")), ("drt", {}), ("drt_clip", dict(trust_clip=BYZ_CLIP)),
             ("trimmed", dict(combine="trimmed:0.25")), ("median", dict(combine="median"))]
    rows, launches = {}, 0
    for name, kw in cells:
        out, c, secs = _counted(lambda: run(device, **kw), device)
        weighted = "combine" not in kw
        got = _check_launches(name, c, dict(slab_combine=BYZ_ROUNDS if weighted else 0), on_card)
        launches += c["slab_combine"]
        cpu = run(torch.device("cpu"), **kw)
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(out[0]), tree_leaves(cpu[0])))
        sens = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(run(torch.device("cpu"), start=nudged,
                                                                               **kw)[0]), tree_leaves(cpu[0])))
        bound = max(MAIN_TOL, 8 * sens)
        assert err <= bound, (name, err, sens)
        m = out[-1]
        assert m.suspicion.shape == (BYZ_ROUNDS, K) and m.byzantine_weight_mass.shape == (BYZ_ROUNDS,)
        rows[name] = dict(drift=drift(out[0]), mass=float(m.byzantine_weight_mass.mean()))
        print(f"  byzantine {name:10s}: honest drift {rows[name]['drift']:.6g}, byzantine_weight_mass "
              f"{rows[name]['mass']:.6g}, suspicion of the attackers (last round) "
              f"{float(m.suspicion[-1][~torch.from_numpy(np.isin(np.arange(K), honest)).to(device)].mean()):.4f}; "
              f"launches {got}; card vs CPU {err:.3e} (bound {bound:.3e}; one ulp of input moves the CPU's "
              f"{sens:.3e}); {secs:.3f} s (host clock, {card})")
    gap = rows["metropolis"]["drift"] / rows["drt_clip"]["drift"]
    mass = rows["drt_clip"]["mass"]
    print(f"  byzantine gap {gap:.6g} (gate > 1.0), byzantine_weight_mass {mass:.6g} (gate < {BYZ_FRACTION})")
    assert gap > 1.0 and mass < BYZ_FRACTION, (gap, mass)
    return launches


def phase_faults(device, rounds=3, argv=("--topologies", "ring", "--epochs", "1")):
    """Byzantine faults and trust-robust consensus on the gather engine.

    1. The draw: the Gauss attack's noise for the 4 masked agents of the
       K=16 ResNet-20 width-16 slab (``prng.normal_at``, the reference's
       region indices), bits equal on the card and the CPU, normals within
       ``prng.NORMAL_ULPS`` ulps; timed (CUDA events, median of 20).
    2. :func:`_byzantine_scenario` (the reference's gates).
    3. One paper-configuration epoch (K=16 ResNet-20 width 16, batch 128,
       ring, the data of ``experiment.make_data``) through
       ``DecentralizedTrainer`` with ``byzantine=0.25, fault_model=
       "sign_flip", trust_clip=0.15``, exact and int8: the local steps,
       then the round-set with the counters set to 0 just before and read
       just after: 1 ``slab_combine`` a round (the per-round body), int8
       also 1 ``slab_quant_encode`` a round at K = 16, nothing else.  The
       round-set is held against the same round-set on CPU tensors, within
       MAIN_TOL (int8: ``rounds`` quantization steps) or 8 times the CPU
       round-set's own change when every input moves one ulp up, whichever
       is larger.  The agents start from one draw and are one epoch apart:
       their distances are differences of nearly equal Gram entries, so
       DRT's weights move with the last bits of the Gram, whose sums the
       card and the CPU take in another order (on an H100, on the
       fault-free Gram path, one ulp of input moved the CPU's A by 0.095
       and its output by 4.2e-4; the card's differed by 0.10 and 5.4e-4).
    4. One ``combine="median"`` epoch the same way: its round-set runs no
       kernel (``torch.sort``).

    ``argv``: the experiment flags of step 3 (the paper's configuration by
    default; a CPU rehearsal passes a tiny one, e.g. ``--width 4
    --image-size 8 --min-samples 32 --max-samples 40 --batch 8``, and
    expects 0 launches).  Returns the launch counts; prints the phase's
    seconds."""
    from repro_torch import experiment, faults
    from repro_torch.comm import prng
    from repro_torch.core.decentralized import DecentralizedState, DecentralizedTrainer, TrainerConfig
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.core.topology import ring
    from repro_torch.data.cifar_like import agent_minibatches
    from repro_torch.models.resnet import init_resnet20, resnet20_agent_losses
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.optim.optimizers import momentum
    from repro_torch.utils.pytree import agent_template, tree_leaves, tree_map

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = _card_line() if on_card else "cpu"
    cpu = torch.device("cpu")
    K = 16
    totals = dict(slab_combine=0, slab_quant_encode=0)

    # 1. the Gauss attack's draw at the paper's shape
    pK, part = _permute_agents(device, K)
    layout = build_slab_layout(part, agent_template(pK))
    slab = layout.pack(pK)
    plan = faults.make_fault_plan(K, byzantine=BYZ_FRACTION, fault_model="gauss:0.5", seed=3)
    real = plan.realize(0, 1, device)
    key = prng.fold_in(real.key, 0)
    pub = faults.apply_fault_regions(plan.model, layout, slab, real.mask[0], key, rows=real.mask_host[0])
    pub_cpu = faults.apply_fault_regions(plan.model, layout, slab.cpu(), real.mask[0].cpu(), key,
                                         rows=real.mask_host[0])
    rows = np.flatnonzero(real.mask_host[0])
    idx = torch.arange(rows.size * layout.D, device=device).view(rows.size, layout.D)
    bits = prng.bits_at(key, idx)
    assert torch.equal(bits.cpu(), prng.bits_at(key, idx.cpu())), "threefry bits differ on the card"
    z = (pub - slab)[rows]
    z_cpu = (pub_cpu - slab.cpu())[rows]
    ulps = ((z.cpu().view(torch.int32).long() - z_cpu.view(torch.int32).long()).abs()).max()
    n_draw = rows.size * layout.D
    if on_card:
        ms_draw = _ms_median(lambda: prng.normal_at(key, idx), 20, lambda: None)
        ms_pub = _ms_median(lambda: faults.apply_fault_regions(plan.model, layout, slab, real.mask[0], key,
                                                               rows=real.mask_host[0]), 20, lambda: None)
    else:
        ms_draw = ms_pub = float("nan")
    print(f"faults phase ({card}): gauss:0.5 noise of {rows.size} masked agents x D={layout.D} "
          f"({n_draw} draws): normal_at {ms_draw:.4f} ms, the whole publish (apply_fault_regions, "
          f"4 groups) {ms_pub:.4f} ms (CUDA events, median of 20); bits card == CPU, "
          f"published values card vs CPU max {int(ulps)} ulps of the sum (bound {prng.NORMAL_ULPS} of "
          f"the noise plus one rounding)")
    assert int(ulps) <= prng.NORMAL_ULPS + 1, int(ulps)

    # 2. the reference's Byzantine scenario and its gates
    totals["slab_combine"] += _byzantine_scenario(device, card, on_card)

    # 3. a paper-configuration epoch under a 25% sign flip, DRT + trust_clip
    args = experiment.parse_args(list(argv))
    shards, _ = experiment.make_data(args)
    batches = agent_minibatches(shards, batch_size=args.batch, epoch_seed=0)
    batches = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}

    def trainer(dev, codec=None, **kw):
        cfg = TrainerConfig(consensus_steps=rounds, codec=codec, byzantine=BYZ_FRACTION, fault_model="sign_flip",
                            trust_clip=BYZ_CLIP, **kw)
        return DecentralizedTrainer(resnet20_agent_losses, lambda g: init_resnet20(g, width=args.width, device=dev),
                                    momentum(args.lr, 0.9), ring(K), cfg, device=dev)

    top = None
    for codec in (None, "int8", "median"):
        kw = dict(combine="median") if codec == "median" else dict(codec=codec)
        tr = trainer(device, **kw)
        st = tr.init(torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        for i in range(next(iter(batches.values())).shape[0]):  # the epoch's local steps
            st, _ = tr.local_step(st, {k: v[i] for k, v in batches.items()})
        t_local = time.perf_counter() - t0
        (st2, A, m), c, secs = _counted(lambda: tr.consensus(st, obs=ObsConfig()), device)
        int8 = codec == "int8"
        want = {} if codec == "median" else dict(slab_combine=rounds, slab_quant_encode=rounds if int8 else 0)
        got = _check_launches(f"epoch {codec}", c, want, on_card)
        for k in totals:
            totals[k] += c[k]
        tr_cpu = trainer(cpu, **kw)
        p_cpu = tree_map(lambda x: x.cpu(), st.params)
        tr_cpu.build_partition(p_cpu)
        t0 = time.perf_counter()
        want_p = tr_cpu.consensus(DecentralizedState(p_cpu, (), st.step, ()))[0].params  # no codec state
        t_cpu = time.perf_counter() - t0
        up = tree_map(lambda x: torch.nextafter(x, torch.full_like(x, math.inf)), p_cpu)
        nudged = tr_cpu.consensus(DecentralizedState(up, (), st.step, ()))[0].params
        if top is None:
            top = 2.0 ** math.ceil(math.log2(max(float(x.abs().max()) for x in tree_leaves(st.params))))

        def diff(got, want):
            d = [(a.cpu() - b).abs().reshape(K, -1) for a, b in zip(tree_leaves(got), tree_leaves(want))]
            return max(float(x.max()) for x in d), sum(int((x > MAIN_TOL).any(dim=0).sum()) for x in d), \
                sum(x.shape[1] for x in d)

        err, cols, n_cols = diff(st2.params, want_p)
        sens, sens_cols, _ = diff(nudged, want_p)
        bound = max(rounds * 1.01 * top / 127.0 if int8 else MAIN_TOL, 8 * sens)
        assert err <= bound, (codec, err, sens, cols, n_cols)
        assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(st2.params))
        mass = m.byzantine_weight_mass.tolist()
        assert all(0.0 <= v < BYZ_FRACTION for v in mass), mass
        print(f"  epoch {str(codec):6s} (K={K} width {args.width}, 25% sign_flip, DRT + trust_clip {BYZ_CLIP}"
              f"{', combine=median' if codec == 'median' else ''}): local steps {t_local:.3f} s, round-set "
              f"{secs:.4f} s (host clock, {card}), launches {got}; byzantine_weight_mass by round "
              f"{[round(v, 5) for v in mass]}; card vs CPU max |diff| {err:.3e} (bound {bound:.3e}), columns "
              f"beyond {MAIN_TOL}: {cols} of {n_cols}; one ulp of input moves the CPU's {sens:.3e}, "
              f"{sens_cols} columns; the CPU round-set {t_cpu:.2f} s")
    print(f"faults phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# slice 17: consensus telemetry on both engines, faults on the edge path
# ---------------------------------------------------------------------------

# card against CPU, each field's largest |difference|: the disagreement, the
# residual and momentum norms and the layer distances within TEL_RTOL of the
# field's largest value (sums of the same f32 terms in another order); the
# wire bytes, edges and rounds run exactly (top-k's bytes within TEL_RTOL: a
# value at the threshold may be sent on one device and not the other after
# round 0); what is read off the mixing weights (entropy, suspicion, the
# Byzantine mass) within MAIN_TOL or 8 times the larger of the CPU's own change
# when every input moves one ulp up (DRT's weights move with the Gram's last
# bits, PERF.md §6) and the gap between the card's and the CPU's last mixing
# weights (the coded and edge kernels take DRT's logs and exponentials with
# CUDA's logf / expf, which differ from torch's in the last bits)
TEL_RTOL = 1e-4
TEL_EXACT = ("wire_send_bytes", "wire_recv_bytes", "compression_ratio", "edges", "effective_rounds")
TEL_WEIGHT = ("mix_entropy", "suspicion", "byzantine_weight_mass")
TEL_BYTES = ("wire_send_bytes", "wire_recv_bytes", "compression_ratio")
TEL_MASS_TOL = 1e-4  # the edge path's Byzantine mass against the slab path's, the same realization


def _telemetry_bounds(got, want, nudged, a_gap=0.0, topk=False):
    """Every field of ``got`` (the card's metrics) against ``want`` (the
    CPU's) under the bounds above; ``nudged`` is the CPU's record from
    inputs one ulp up, ``a_gap`` the largest |difference| of the two
    devices' last mixing weights.  Returns ``{field: (max |diff|,
    bound)}``."""
    out = {}
    for name in got._fields:
        a, b = getattr(got, name).detach().cpu().double(), getattr(want, name).double()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        if name in TEL_BYTES and topk:
            bound = TEL_RTOL * scale
        elif name in TEL_EXACT:
            bound = 0.0
        elif name in TEL_WEIGHT:
            sens = float((getattr(nudged, name).double() - b).abs().max()) if b.numel() else 0.0
            bound = max(MAIN_TOL, 8 * max(sens, a_gap))
        else:
            bound = TEL_RTOL * scale
        out[name] = (err, bound)
    return out


def _assert_bounds(label, bounds):
    bad = {k: v for k, v in bounds.items() if not v[0] <= v[1]}
    assert not bad, (label, bad)
    worst = max(bounds, key=lambda k: bounds[k][0] / bounds[k][1] if bounds[k][1] else 0.0)
    return f"every field within its bound (closest: {worst} {bounds[worst][0]:.3e} of {bounds[worst][1]:.3e})"


def phase_telemetry(device, rounds=3, permute_rounds=2, width=16):
    """Consensus telemetry on every path of both engines, and faults with
    trust reweighting on the edge path, at the paper's shape (K=16 ResNet-20
    width 16, agents drawn apart, GroupNorm untied; ring).

    1. Every gather path with ``obs`` (slab exact DRT and classical, int8,
       bf16, f16 classical, topk:0.1, int8 with trust_clip 0.15 on the
       per-round body; edge exact with CSR tables, edge int8 without them
       with momentum 0.4; the tree oracle): the round-set on the card with
       and without ``obs``, each with the counters set to 0 just before and
       read just after: outputs bit for bit, every consensus kernel's
       launches the same and as the path's formula says; the record field
       by field against the same round-set on CPU tensors
       (:func:`_telemetry_bounds`).  Host seconds of the round-set with
       ``obs`` on and off (the better of two runs each).
    2. The reference's Byzantine ring on the edge path: 25% sign-flip
       agents, DRT + trust_clip 0.15, exact and int8 with CSR tables: 2
       ``slab_edge_encode_combine`` launches a round (int8 also one
       ``slab_quant_encode``), the Byzantine weight mass against the slab
       path's on the same realization (within TEL_MASS_TOL), the output and
       the record against the CPU's (exact: MAIN_TOL or 8 times the CPU's
       one-ulp nudge; int8: ``rounds`` quantization steps).
    3. ``PermuteConsensus`` (16 agents as 16 threads) on its slab path (DRT
       exact, momentum 0.4) and tree path (DRT exact) with ``obs`` on and
       off: outputs bit for bit, launches the same, every rank's record
       against its CPU run (the weights within MAIN_TOL: the agents are
       apart and the rank's column is torch's arithmetic on both devices);
       host seconds on and off.
    4. The records of 1-3 through ``JsonlSink`` into a file and back
       (``read_jsonl``), ``summarize`` printed.
    5. A ``torch.profiler`` trace (``obs.trace``) of annotated round-sets:
       the five ``consensus.*`` spans and the kernels in it.

    ``width``: the agents' ResNet-20 width (16, the paper's; a CPU
    rehearsal passes a smaller one and expects 0 launches).  Returns the
    launch counts of the counted runs; prints the phase's seconds."""
    import tempfile

    from repro_torch import PermuteConsensus, faults, obs, spmd_run
    from repro_torch.comm import prng
    from repro_torch.core import consensus, dynamic
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = _card_line() if on_card else "cpu"
    cpu = torch.device("cpu")
    K = 16
    pK, part = _permute_agents(device, K, width=width)
    p_cpu = tree_map(lambda x: x.cpu(), pK)
    p_up = tree_map(lambda x: torch.nextafter(x, torch.full_like(x, math.inf)), p_cpu)
    topo = ring(K)
    C, M = topo.c_matrix(), topo.metropolis()
    top = 2.0 ** math.ceil(math.log2(max(float(x.abs().max()) for x in tree_leaves(pK))))
    totals = collections.Counter()
    records = []

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def diff(a, b):
        return max(float((x.cpu() - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # 1. every gather path, obs on and off
    edges = {dev: dynamic.edge_stacks_from_topology(topo, rounds, dev) for dev in (device, cpu)}
    paths = [  # (label, keywords, launches of the round-set)
        ("slab exact drt", {}, dict(slab_combine=1)),
        ("slab exact classical", dict(algorithm="classical"), dict(slab_combine=1)),
        ("slab int8 drt", dict(codec="int8"), dict(slab_encode_combine=2 * rounds)),
        ("slab bf16 drt", dict(codec="bf16"), dict(slab_encode_combine=2 * rounds)),
        ("slab f16 classical", dict(codec="f16", algorithm="classical"), dict(slab_encode_combine=rounds)),
        ("slab topk:0.1 drt", dict(codec="topk:0.1"), dict(slab_encode_combine=2 * rounds)),
        ("slab int8 drt clip", dict(codec="int8", trust_clip=BYZ_CLIP),
         dict(slab_combine=rounds, slab_quant_encode=rounds)),
        ("edge exact drt csr", dict(path="edge", max_in_degree=2), dict(slab_edge_encode_combine=2 * rounds)),
        ("edge int8 drt scatter momentum", dict(path="edge", codec="int8", momentum=CONTROL_BETA),
         dict(slab_edge_combine=2 * rounds, slab_quant_encode=rounds)),
        ("tree exact drt", dict(path="tree"), {}),
    ]
    print(f"telemetry phase ({card}): K={K} width {width}, ring, {rounds} rounds; host seconds of a round-set "
          f"with obs on / off (better of two runs each)")
    for label, kw, want in paths:

        def run(dev, start=None, obs_cfg=ObsConfig(), kw=kw):
            p = start if start is not None else (pK if dev == device else p_cpu)
            extra = dict(edges=edges[dev]) if kw.get("path") == "edge" else {}
            return consensus.gather_consensus_rounds(
                part, p, C, DRTConfig(), rounds=rounds, metropolis=M, rng=prng.key(19), obs=obs_cfg,
                **extra, **kw)

        run(device)  # warm: maps, plans and workspaces on the device
        on, c_on, s_on = _counted(lambda: run(device), device)
        off, c_off, s_off = _counted(lambda: run(device, obs_cfg=None), device)
        s_on = min(s_on, _counted(lambda: run(device), device)[2])
        s_off = min(s_off, _counted(lambda: run(device, obs_cfg=None), device)[2])
        assert c_on == c_off, (label, c_on, c_off)
        got = _check_launches(label, c_on, want, on_card)
        totals.update(c_on)
        assert same(on[0], off[0]) and len(on) == len(off) + 1, f"{label}: obs changed the round-set"
        m = on[-1]
        # a classical round's weights are the Metropolis matrix: no nudge to measure
        want_cpu = run(cpu)
        nudged = want_cpu if kw.get("algorithm") == "classical" else run(cpu, start=p_up)
        a_gap = float((on[1].cpu() - want_cpu[1]).abs().max())
        bounds = _telemetry_bounds(m, want_cpu[-1], nudged[-1], a_gap, topk=kw.get("codec") == "topk:0.1")
        note = _assert_bounds(label, bounds) + f"; last A card vs CPU {a_gap:.3e}"
        coarse = kw.get("codec") in ("int8", "topk:0.1")
        err = diff(on[0], want_cpu[0])
        sens = diff(nudged[0], want_cpu[0])
        bound = max(rounds * 1.01 * top / 127.0 if coarse else MAIN_TOL, 8 * sens)
        assert err <= bound, (label, err, bound)
        records += [dict(r, path=label) for r in obs.consensus_records(m, step=0)]
        print(f"  {label:32s}: on {s_on:.4f} s, off {s_off:.4f} s; launches {got} with obs on and off; out "
              f"card vs CPU {err:.3e} (bound {bound:.3e}); {note}; last round: disagreement "
              f"{float(m.disagreement[-1]):.6g}, send {float(m.wire_send_bytes[-1]):.0f} B, ratio "
              f"{float(m.compression_ratio[-1]):.4f}, entropy {float(m.mix_entropy[-1]):.4f}, ef "
              f"{float(m.ef_residual[-1]):.4g}, momentum {float(m.momentum_norm[-1]):.4g}")

    # 2. the Byzantine ring on the edge path
    plan = faults.make_fault_plan(K, byzantine=BYZ_FRACTION, fault_model="sign_flip", seed=0)
    for codec in (None, "int8"):
        label = f"edge {codec or 'exact'} sign_flip clip"

        def run(dev, start=None, path="edge", codec=codec):
            p = start if start is not None else (pK if dev == device else p_cpu)
            extra = dict(edges=edges[dev], max_in_degree=2) if path == "edge" else {}
            return consensus.gather_consensus_rounds(
                part, p, C, DRTConfig(), rounds=rounds, codec=codec, rng=prng.key(23), obs=ObsConfig(),
                faults=plan.realize(0, rounds, dev), trust_clip=BYZ_CLIP, path=path, **extra)

        run(device)
        out, c, secs = _counted(lambda: run(device), device)
        got = _check_launches(label, c, dict(slab_edge_encode_combine=2 * rounds,
                                             slab_quant_encode=rounds if codec else 0), on_card)
        assert c["slab_edge_encode_combine_calls"] == (rounds if on_card else 0), c
        totals.update(c)
        m = out[-1]
        slab = run(device, path="slab")[-1]
        mass_gap = float((m.byzantine_weight_mass - slab.byzantine_weight_mass).abs().max())
        assert mass_gap <= TEL_MASS_TOL and float(m.byzantine_weight_mass.max()) < BYZ_FRACTION, (label, mass_gap)
        want_cpu, nudged = run(cpu), run(cpu, start=p_up)
        a_gap = float((out[1].cpu() - want_cpu[1]).abs().max())
        note = _assert_bounds(label, _telemetry_bounds(m, want_cpu[-1], nudged[-1], a_gap))
        err, sens = diff(out[0], want_cpu[0]), diff(nudged[0], want_cpu[0])
        bound = max(rounds * 1.01 * top / 127.0 if codec else MAIN_TOL, 8 * sens)
        assert err <= bound, (label, err, bound)
        records += [dict(r, path=label) for r in obs.consensus_records(m, step=1)]
        print(f"  {label:32s}: {secs:.4f} s; launches {got} ({rounds} calls); byzantine_weight_mass by round "
              f"{[round(v, 5) for v in m.byzantine_weight_mass.tolist()]}, the slab path's "
              f"{[round(v, 5) for v in slab.byzantine_weight_mass.tolist()]} (max gap {mass_gap:.2e}); out card "
              f"vs CPU {err:.3e} (bound {bound:.3e}); {note}")

    # 3. the permute engine, slab and tree paths
    for path, kw in (("slab", dict(momentum=CONTROL_BETA)), ("tree", {})):
        eng = PermuteConsensus(part, topo, DRTConfig(), path=path, **kw)

        def run(p, obs_cfg=ObsConfig(), eng=eng):
            dev = tree_leaves(p)[0].device
            return spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], p), ex, rounds=permute_rounds, obs=obs_cfg),
                            K, device=dev)

        label = f"permute {path} drt"
        on, c_on, s_on = _counted(lambda: run(pK), device)
        off, c_off, s_off = _counted(lambda: run(pK, obs_cfg=None), device)
        assert c_on == c_off, (label, c_on, c_off)
        n_ex = 2 * permute_rounds  # the ring's two permutations a round
        want = dict(drt_dist=K * n_ex, slab_source_combine=K * permute_rounds) if path == "slab" else {}
        got = _check_launches(label, c_on, want, on_card)
        totals.update(c_on)
        assert all(same(a[0], b) for a, b in zip(on, off)), f"{label}: obs changed the round-set"
        t0 = time.perf_counter()
        cpu_out = run(p_cpu)
        t_cpu = time.perf_counter() - t0
        notes = []
        for rank in range(K):
            # no nudged run: the agents are apart, so the weights within MAIN_TOL
            bounds = _telemetry_bounds(on[rank][-1], cpu_out[rank][-1], cpu_out[rank][-1])
            notes.append(_assert_bounds(f"{label} rank {rank}", bounds))
            records += [dict(r, path=label) for r in obs.consensus_records(on[rank][-1], step=2, agent=rank)]
        err = max(diff(a[0], b[0]) for a, b in zip(on, cpu_out))
        assert err <= MAIN_TOL, (label, err)
        m = on[0][-1]
        print(f"  {label:32s}: on {s_on:.3f} s, off {s_off:.3f} s ({permute_rounds} rounds); launches {got} with "
              f"obs on and off; out card vs CPU {err:.3e}; rank 0 {notes[0]}; rank 0's last round: disagreement "
              f"{float(m.disagreement[-1]):.6g}, send {float(m.wire_send_bytes[-1]):.0f} B, entropy "
              f"{float(m.mix_entropy[-1]):.4f}, momentum {float(m.momentum_norm[-1]):.4g}; the CPU round-set "
              f"{t_cpu:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        # 4. the JSONL sink
        path = os.path.join(tmp, "telemetry.jsonl")
        with obs.JsonlSink(path) as sink:
            for rec in records:
                sink.write(rec)
        back = obs.read_jsonl(path)
        assert back == json.loads(json.dumps(records)) and len(back) == len(records), "JSONL round trip"
        summary = obs.summarize(back)
        assert summary["edges"]["mean"] == float(K), summary["edges"]
        print(f"  JSONL: {len(back)} records written and read back ({os.path.getsize(path)} bytes); summarize:")
        print("    " + obs.format_summary(summary).replace("\n", "\n    "))

        # 5. a profiler trace of annotated round-sets
        ann = ObsConfig(annotate=True)
        prof_dir = os.path.join(tmp, "profile")
        with obs.trace(prof_dir), obs.annotation("telemetry.chunk"):
            consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), rounds=rounds, obs=ann)
            consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), rounds=rounds, codec="int8", rng=prng.key(3),
                                              path="edge", edges=edges[device], obs=ann)
            if on_card:
                torch.cuda.synchronize()
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    spans = ("consensus.pack", "consensus.encode", "consensus.decode", "consensus.combine", "consensus.unpack")
    assert all(names[s] > 0 for s in spans + ("telemetry.chunk",)), {s: names[s] for s in spans}
    kernels = sum(n for k, n in names.items() if k and "_kernel" in k and "at::" not in k)
    assert kernels > 0 or not on_card, "the trace holds no kernel of the port"
    print(f"  profiler trace: spans {dict((s, names[s]) for s in spans)}, {kernels} launches of the port's "
          f"kernels, {len(events)} events")
    print(f"telemetry phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(totals)


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
# kernel vs plain on the card.  f32 (the CUDA-core kernel): sums over keys
# (scan steps) in another order, with and without fused multiply-adds.
# bf16 (the tensor-core kernel): both round an f32 result to bf16 (one step,
# 2^-7 relative), and the kernel rounds P to bf16 before P V, which moves o
# by at most 2^-9 sum_j softmax_j |v_j| <= 2^-9 max|v|: rtol 2^-7 plus atol
# 2^-8 max|v| (the atol's second factor is taken from the inputs)
FA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-7, 2.0**-8)}  # (rtol, atol or atol / max|v|)
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


def _scan_bound(B, S, di, ds):
    """The scan's least time in ms at x bf16, the larger of its bytes (dt,
    y f32; x bf16; B, C f32; A, h_last f32) over the memory rate and its
    exponentials over the multi-function units' rate: ``(bound, bytes ms,
    exp ms, bytes, exponentials)``."""
    n_bytes = 4 * B * S * di + 2 * B * S * di + 4 * B * S * di + 2 * 4 * B * S * ds + 4 * di * ds + 4 * B * di * ds
    n_exp = B * S * di * ds
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_exp / PEAK_EXP_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, n_bytes, n_exp


def _sass(name):
    """The SASS of one built kernel library (``cuobjdump -sass`` from
    nvcc's toolkit)."""
    from repro_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))], capture_output=True, text=True,
                          check=True).stdout


# an instruction's opcode in cuobjdump's listing, after its address and predicate
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)")


# instructions that end a straight run of code
_SASS_FLOW = ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "DEPBAR", "LDGDEPBAR", "WARPSYNC")


def _sass_body(sass, head):
    """The SASS of the one function of a library's listing whose mangled
    name holds ``head``."""
    return next(f for f in sass.split("Function : ") if head in f.split("\n", 1)[0])


def _straight_runs(body):
    """Opcode counts of each straight run of a function's SASS: the code
    between two branches or barriers."""
    runs, run = [], collections.Counter()
    for op in _SASS_OP.findall(body):
        if op.split(".")[0] in _SASS_FLOW:
            runs.append(run)
            run = collections.Counter()
        else:
            run[op] += 1
    return runs + [run]


def _scan_tile_sass(sass, lanes, states):
    """Opcode counts per state-step of ``selective_scan_kernel<bf16, lanes,
    states>``'s unrolled 16-step tile: the straight run of code (no branch
    or barrier) that holds the most exponentials, each count over its
    ``MUFU.EX2`` count.  Returns ``(exponentials, {opcode: per
    state-step}, instructions per state-step)``."""
    body = _sass_body(sass, f"selective_scan_kernelI13__nv_bfloat16Li{lanes}ELi{states}E")
    tile = max(_straight_runs(body), key=lambda c: c["MUFU.EX2"])
    n = tile["MUFU.EX2"]
    return n, {op: round(k / n, 3) for op, k in tile.most_common()}, sum(tile.values()) / n


def _sass_check():
    """The built libraries' SASS: ``flash_attention`` must hold tensor-core
    products (``HGMMA``) and TMA loads (``UTMALDG``), ``slab_combine`` TMA
    loads (its TMA stores, ``UTMASTG``, are counted too); ``selective_scan``
    exponentials (``MUFU.EX2``), the y butterfly over lanes (``SHFL.BFLY``)
    and ``cp.async`` prefetches (``LDGSTS``), with the 1- and 2-lane
    instances' instructions per state-step printed."""
    from repro_torch.kernels.selective_scan import MAX_STATE

    for name, needs in (("flash_attention", ("HGMMA", "UTMALDG")), ("slab_combine", ("UTMALDG",)),
                        ("selective_scan", ("MUFU.EX2", "SHFL.BFLY", "LDGSTS"))):
        sass = _sass(name)
        counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
                  for op in ("HGMMA", "UTMALDG", "UTMASTG", "MUFU.EX2", "SHFL.BFLY", "LDGSTS")}
        print(f"SASS {name}: { {op: n for op, n in counts.items() if n} }")
        assert all(counts[op] > 0 for op in needs), (name, counts)
    for lanes in (1, 2):
        n, per_step, total = _scan_tile_sass(sass, lanes, MAX_STATE // lanes)
        print(f"SASS selective_scan_kernel<bf16,{lanes},{MAX_STATE // lanes}> unrolled tile ({n} exponentials): "
              f"{total:.2f} instructions per state-step: {per_step}")


# one SASS instruction: its address, an optional predicate, its opcode and operands
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)([^;]*);")


def _fast_path(insns):
    """The opcodes that one thread issues from the kernel's entry when every
    IEEE division takes its fast path (each ``FCHK`` predicate false, so
    its branch over the slow-path call is taken) and its warp takes the
    shared-word branch (each ``VOTE.ALL`` predicate true): predicated
    instructions count whether or not they act; a predicated ``EXIT`` is
    not taken.  Raises on a branch on any other predicate."""
    at = {ad: i for i, (ad, _, _, _) in enumerate(insns)}
    truth, path, i = {}, [], 0
    while True:
        ad, pred, op, rest = insns[i]
        if op != "NOP":
            path.append(op)
        regs = re.findall(r"\bU?P[0-6]\b", rest)
        if op.startswith("FCHK"):
            truth[regs[0]] = False
        elif op.startswith("VOTE") and ".ALL" in op:
            truth[regs[0]] = True
        if op == "EXIT" and not pred:
            return path
        if op.startswith("BRA"):
            taken = True
            if pred:
                name = pred.strip().lstrip("@")
                taken = truth[name.lstrip("!")] != name.startswith("!")
            if taken:
                i = at[int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)]
                continue
        i += 1


def _quant_sass_report():
    """``quant_encode_kernel``'s SASS (``cuobjdump``): the instructions a
    thread issues for its 4 elements on the fast path (:func:`_fast_path`),
    in total, per element, and by opcode per element."""
    body = _sass_body(_sass("slab_codec"), "quant_encode_kernel")
    path = _fast_path([(int(ad, 16), pred, op, rest) for ad, pred, op, rest in _SASS_INSN.findall(body)])
    ops = collections.Counter(path)
    assert ops["FCHK"] == 4 and ops["FRND.FLOOR"] == 4 and not any(op.startswith("CALL") for op in ops), ops
    print(f"SASS quant_encode_kernel: {len(path)} instructions on a thread's fast path for its 4 elements "
          f"({len(path) / 4:.2f} an element); per element {dict((op, k / 4) for op, k in ops.most_common())}")
    return len(path) / 4


def phase_lm_kernels(device):
    """``flash_attention`` (bf16 on its tensor-core kernel and f32 on its
    CUDA-core kernel, causal, at the qwen3-4b prefill shape and at S 2047
    and 37 < one tile) and ``selective_scan`` (x bf16 and f32, y and
    h_last, at the falcon-mamba-7b prefill shape and S 2047 and 37, two runs
    bit-identical) against their plain versions, SDPA's distance from the
    plain version beside the bf16 kernel's; times at the full shapes (bf16
    attention, bf16 x), the scan at every lane count it takes; the SASS
    check."""
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    _sass_check()
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    fa = FA_SHAPE
    fa_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = FA_TOL[dtype]
        for S in (fa["S"], 2047, 37):
            q, k, v = _attention_operands(fa["B"], fa["H"], fa["Hkv"], S, fa["hd"], dtype)
            tc_before = flash_attention.tc_launches
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert flash_attention.tc_launches - tc_before == (dtype == torch.bfloat16)
            ref = flash_attention_ref(q, k, v)
            assert out.dtype == dtype and out.shape == ref.shape
            if dtype == torch.bfloat16:
                atol_v = atol * float(v.float().abs().max())
                sdpa_out = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
                sdpa = f"; |SDPA - plain| {float((sdpa_out.float() - ref.float()).abs().max()):.3e}"
            else:
                atol_v, sdpa = atol, ""
            d = (out.float() - ref.float()).abs()
            excess = float((d - (atol_v + rtol * ref.float().abs())).max())
            err = float(d.max())
            kernel = "tensor-core" if dtype == torch.bfloat16 else "CUDA-core"
            print(f"flash_attention {str(dtype)[6:]} ({kernel} kernel) B={fa['B']} H={fa['H']}/{fa['Hkv']} S={S} "
                  f"hd={fa['hd']} causal: max |kernel - plain| = {err:.3e} (tol {atol_v:.3g} + {rtol:.3g} x |plain|)"
                  f"{sdpa}")
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
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = _ms_median(lambda: flash_attention(q32, k32, v32), 10, flush)
    B, H, Hkv, S, hd = fa["B"], fa["H"], fa["Hkv"], fa["S"], fa["hd"]
    n_bytes = 2 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)  # q, o (H heads), k, v (Hkv), bf16
    n_flops = 2 * B * H * S * S * hd  # q k^T and p v over the causal triangle
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_BF16_FLOPS * 1e3
    fa_bound = max(t_bytes, t_ops)
    print(f"flash_attention timing (bf16 tensor-core kernel, causal, median, L2 flushed, device time): kernel "
          f"{timed['ms']:.4f} ms ({n_flops / timed['ms'] / 1e9:.1f} TFLOP/s), plain {timed['plain_ms']:.4f} ms, "
          f"SDPA {timed['library_ms']:.4f} ms (|SDPA - plain| {lib_err:.3e}); bound {fa_bound:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16); the f32 CUDA-core kernel on the "
          f"same inputs in f32 {f32_ms:.4f} ms")
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
            before = selective_scan.launches
            (y, h), again = selective_scan(*ops), selective_scan(*ops)
            torch.cuda.synchronize()
            assert selective_scan.launches == before + 2
            assert torch.equal(y, again[0]) and torch.equal(h, again[1]), ("not bit-reproducible", x_dtype, S)
            y_ref, h_ref = selective_scan_ref(*ops)
            ey, eh = float((y - y_ref).abs().max()), float((h - h_ref).abs().max())
            ty = SCAN_TOL * max(1.0, float(y_ref.abs().max()))
            th = SCAN_TOL * max(1.0, float(h_ref.abs().max()))
            print(f"selective_scan x {str(x_dtype)[6:]} B={sc['B']} S={S} di={sc['di']} ds={sc['ds']}: "
                  f"max |kernel - plain| y {ey:.3e} (tol {ty:.2e}), h_last {eh:.3e} (tol {th:.2e}), "
                  f"two runs identical")
            assert ey <= ty and eh <= th, (x_dtype, S, ey, eh)
            if S == sc["S"] and x_dtype == torch.bfloat16:
                scan_err = max(ey, eh)
    ops = _scan_operands(sc["B"], sc["S"], sc["di"], sc["ds"], torch.bfloat16)
    fns = {"ms": lambda: selective_scan(*ops), "plain_ms": lambda: selective_scan_ref(*ops)}
    for f in fns.values():
        f()
    timed = {"ms": _ms_median(fns["ms"], 30, flush), "plain_ms": _ms_median(fns["plain_ms"], 3, flush)}
    scan_bound, t_bytes, t_ops, n_bytes, n_exp = _scan_bound(**sc)
    print(f"selective_scan timing (x bf16, lanes a channel {ss.lanes_for(sc['B'] * sc['di'], device)}, median, "
          f"L2 flushed, device time): kernel "
          f"{timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} ms; no PyTorch call computes the scan; bound "
          f"{scan_bound:.4f} ms ({n_bytes / 1e6:.1f} MB; {n_exp / 1e9:.3f} G exp at {PEAK_EXP_PER_S / 1e12:.2f} "
          f"T exp/s)")
    # the design's choice: both lane counts the kernel takes, at this batch and below
    for B in (sc["B"], 2, 1):
        ops_b = _scan_operands(B, sc["S"], sc["di"], sc["ds"], torch.bfloat16)
        lane_ms = {g: round(_ms_median(lambda g=g: ss._launch(*ops_b, g), 10, flush), 4) for g in (1, 2)}
        print(f"selective_scan lanes a channel -> ms, x bf16 B={B} S={sc['S']} di={sc['di']}: {lane_ms}, the wrapper "
              f"takes {ss.lanes_for(B * sc['di'], device)} (bound {_scan_bound(B, sc['S'], sc['di'], sc['ds'])[0]:.4f} "
              f"ms)")
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
    attention layer (36, all on its bf16 tensor-core kernel) or one
    ``selective_scan`` per Mamba layer (64) in the prefill, none in decode,
    no other kernel.  Returns the counts."""
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
        assert c[kernel] == n_layers and all(n == 0 for name, n in c.items() if not name.startswith(kernel)), c
        if kernel == "flash_attention":  # bf16 prefill: every launch on the tensor-core kernel
            assert c["flash_attention_tc"] == n_layers, c
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



# ---------------------------------------------------------------------------
# slice 18: decentralized LM training (dense family, gather engine)
# ---------------------------------------------------------------------------

# the backward's operands at the full-width train step's shape (batch 1 a agent)
FA_TRAIN_SHAPE = dict(B=1, H=32, Hkv=8, S=2048, hd=128)
TRAIN_K, TRAIN_LAYERS, TRAIN_STEPS = 4, 2, 3
# the CLI runs held card against CPU: (label, extra flags, launches a step on the card)
TRAIN_CLI = (
    ("exact slab", (), dict(slab_combine=1)),
    ("int8 slab", ("--codec", "int8"), dict(slab_encode_combine=2)),
    ("edge sign_flip clip", ("--consensus-path", "edge", "--byzantine", "0.25", "--fault-model", "sign_flip",
                             "--trust-clip", "0.15"), dict(slab_edge_encode_combine=2)),
)


def _bwd_tol(dtype, ref):
    """The backward kernel against its plain version on the same inputs
    (``kernels/flash_attention.py``'s docstring): f32, 1e-5 of the largest
    |value|; bf16, rtol 2^-7 (both round an f32 result once to bf16) plus
    2^-10 of the largest |value| (the f32 sums' order); the scale never
    under 1 (O(1) terms)."""
    m = max(float(ref.float().abs().max()), 1.0)
    return (0.0, 1e-5 * m) if dtype == torch.float32 else (2.0**-7, 2.0**-10 * m)


def _bwd_kernel_checks(device, flush):
    """The backward kernel at the training shape and at S 2047 and 37, bf16
    and f32, given the forward kernel's o and log-sum-exp (the LSE itself
    against the plain version's): within :func:`_bwd_tol`, two runs
    bit-identical, BWD_LAUNCHES_PER_CALL launches a call; then timed beside
    its bound, the plain version and SDPA's backward.  Returns the
    ``kernels`` row."""
    from repro_torch.kernels import flash_attention as fa

    sh = FA_TRAIN_SHAPE
    err_bf16 = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for S in (sh["S"], 2047, 37):
            q, k, v = _attention_operands(sh["B"], sh["H"], sh["Hkv"], S, sh["hd"], dtype)
            o, lse = fa.flash_attention(q, k, v, return_lse=True)
            lse_err = float((lse - fa.flash_attention_ref(q, k, v, return_lse=True)[1]).abs().max())
            assert lse_err <= (1e-5 if dtype == torch.float32 else 1e-4), (dtype, S, lse_err)
            do = _attention_operands(sh["B"], sh["H"], sh["Hkv"], S, sh["hd"], dtype, seed=1)[0]
            before = fa.flash_attention_bwd.launches
            got, again = fa.flash_attention_bwd(q, k, v, o, do, lse), fa.flash_attention_bwd(q, k, v, o, do, lse)
            torch.cuda.synchronize()
            assert fa.flash_attention_bwd.launches - before == 2 * fa.BWD_LAUNCHES_PER_CALL
            parts = []
            for name, a, b, r in zip(("dq", "dk", "dv"), got, again, fa.flash_attention_bwd_ref(q, k, v, o, do, lse)):
                assert torch.equal(a, b), ("flash_attention_bwd not bit-reproducible", dtype, S, name)
                rtol, atol = _bwd_tol(dtype, r)
                d = (a.float() - r.float()).abs()
                assert float((d - (atol + rtol * r.float().abs())).max()) <= 0.0, (dtype, S, name, float(d.max()))
                parts.append(f"{name} {float(d.max()):.3e} (tol {atol:.3g} + {rtol:.3g} x |plain|)")
                if dtype == torch.bfloat16 and S == sh["S"]:
                    err_bf16 = max(err_bf16, float(d.max()))
            print(f"flash_attention_bwd {str(dtype)[6:]} B={sh['B']} H={sh['H']}/{sh['Hkv']} S={S} hd={sh['hd']}: "
                  f"max |kernel - plain| {'; '.join(parts)}; lse vs plain {lse_err:.3e}; two runs identical, "
                  f"{fa.BWD_LAUNCHES_PER_CALL} launches a call")
    B, H, Hkv, S, hd = sh["B"], sh["H"], sh["Hkv"], sh["S"], sh["hd"]
    q, k, v = _attention_operands(B, H, Hkv, S, hd, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = _attention_operands(B, H, Hkv, S, hd, torch.bfloat16, seed=1)[0]
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), (qs, ks, vs), do)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)

    fns = {"ms": lambda: fa.flash_attention_bwd(q, k, v, o, do, lse),
           "plain_ms": lambda: fa.flash_attention_bwd_ref(q, k, v, o, do, lse),
           "fwd_lse": lambda: fa.flash_attention(q, k, v, return_lse=True),
           "fwd": lambda: fa.flash_attention(q, k, v), "sdpa_fb": sdpa_fwd_bwd, "sdpa_f": sdpa_fwd}
    for f in fns.values():
        f()
    t = {name: _ms_median(f, 5 if name == "plain_ms" else 20, flush) for name, f in fns.items()}
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention(q32, k32, v32, return_lse=True)
    f32_ms = _ms_median(lambda: fa.flash_attention_bwd(q32, k32, v32, o32, do32, lse32), 5, flush)
    n_flops = 2.5 * 2 * B * H * S * S * hd  # five products of the causal triangle
    n_bytes = 2 * (3 * B * H * S * hd + 4 * B * Hkv * S * hd) + 4 * B * H * S  # q o do dq; k v dk dv; lse
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_flops / PEAK_BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    library = t["sdpa_fb"] - t["sdpa_f"]
    print(f"flash_attention_bwd timing (bf16, B={B} H={H}/{Hkv} S={S} hd={hd}, median, L2 flushed, device time): "
          f"kernel {t['ms']:.4f} ms ({n_flops / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms, SDPA "
          f"backward {library:.4f} ms (forward + backward {t['sdpa_fb']:.4f} - forward {t['sdpa_f']:.4f}); bound "
          f"{bound:.4f} ms ({n_flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16; {t_bytes:.4f} ms of bytes); the same "
          f"inputs in f32 {f32_ms:.4f} ms (f32 bound {n_flops / PEAK_F32_FLOPS * 1e3:.4f} ms at 67 TFLOP/s); "
          f"forward kernel here {t['fwd']:.4f} ms, with the log-sum-exp {t['fwd_lse']:.4f} ms")
    return {
        "name": "flash_attention_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:132 (no TPU kernel: the reference differentiates its jnp attention)",
        "launches": None, "max_abs_err": err_bf16, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library,
    }


def _full_width_train(device):
    """qwen3-4b at every width, depth cut to TRAIN_LAYERS layers
    (``dataclasses.replace``), TRAIN_K agents on a ring, batch 1 an agent,
    sequence 2048, momentum(0.1, 0.9), exact DRT on the slab, remat as the
    config sets it: TRAIN_STEPS steps through ``make_train_step``, each with
    the counters set to 0 just before and read just after (K x layers x
    (1 + remat) forward launches, all on the tensor-core kernel, K x layers
    backward calls, one ``slab_combine``, no other kernel).  Returns the
    counts summed over the steps."""
    import dataclasses

    from repro_torch.comm import prng
    from repro_torch.core.topology import ring
    from repro_torch.data.synthetic import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES_PER_CALL
    from repro_torch.launch import train
    from repro_torch.models.registry import build_bundle, get_config
    from repro_torch.optim.optimizers import momentum
    from repro_torch.utils.pytree import tree_leaves

    full = get_config("qwen3-4b", num_agents=TRAIN_K)
    cfg = dataclasses.replace(full, groups=(dataclasses.replace(full.groups[0], repeat=TRAIN_LAYERS),))
    assert cfg.remat and cfg.n_layers == TRAIN_LAYERS
    bundle = build_bundle(cfg)
    opt = momentum(0.1, 0.9)
    S = FA_TRAIN_SHAPE["S"]
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = train.init_train_state(bundle, opt, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    D = sum(x[0].numel() for x in tree_leaves(state.params))
    step = train.make_train_step(bundle, ring(TRAIN_K), opt, device=device)
    stream = SyntheticTokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=S))
    calls = TRAIN_K * TRAIN_LAYERS
    want = dict(flash_attention=calls * (1 + cfg.remat), flash_attention_bwd=calls * BWD_LAUNCHES_PER_CALL,
                slab_combine=1)
    print(f"train qwen3-4b widths (d {cfg.d_model}, heads {cfg.attn.n_heads}/{cfg.attn.n_kv_heads}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}), {TRAIN_LAYERS} of {full.n_layers} layers, K={TRAIN_K} ring, batch 1, seq {S}, "
          f"remat {cfg.remat}: D = {D:,} parameters an agent, init {init_s:.2f} s, "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB after init", flush=True)
    totals = collections.Counter()
    secs = []
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.from_numpy(stream.agent_batches(1, TRAIN_K, step=i))}
        _reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step(state, batch, prng.key(i))
        loss = float(m["loss"])
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
        c = _counters()
        got = _check_launches(f"train step {i}", c, want, True)
        assert c["flash_attention_tc"] == want["flash_attention"] and c["flash_attention_bwd_calls"] == calls, c
        assert math.isfinite(loss), (i, loss)
        totals.update(got)
        print(f"  train step {i}: loss {loss:.4f}, {secs[-1]:.3f} s ({TRAIN_K * S / secs[-1]:.0f} tokens/s), "
              f"launches {got}", flush=True)
    peak = torch.cuda.max_memory_allocated(device)
    assert peak < 80e9, peak
    box = {"state": state}
    del state

    def one_more():  # outside the counted steps: where a steady step's device time goes
        box["state"] = step(box["state"], {"tokens": torch.from_numpy(stream.agent_batches(1, TRAIN_K, step=9))},
                            prng.key(9))[0]

    _profile_window("train step (full width, steady)", one_more)
    state = box.pop("state")
    steady = statistics.median(secs[1:])
    print(f"train full width: step seconds {[round(x, 4) for x in secs]} (steady {steady:.4f} s, "
          f"{TRAIN_K * S / steady:.0f} tokens/s), peak device memory {peak / 1e9:.2f} GB "
          f"({torch.cuda.get_device_properties(device).total_memory / 1e9:.1f} GB card)")
    for x in tree_leaves(state.params):
        assert bool(torch.isfinite(x).all())
    del step, m
    _full_width_combine_check(state, device)
    return dict(totals)


def _full_width_combine_check(state, device):
    """``slab_combine`` on the full-width (K, D) slab the exact path packs
    (K D ~ 3.9e9 elements, past 2^31) with seeded column-stochastic blocks,
    held to its plain version at the first, middle and last column blocks
    within MAIN_TOL: the last agent's last columns lie past 2^31 elements,
    where a 32-bit index would wrap.  Outside the counted steps."""
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.kernels.slab_combine import LANES, slab_combine, slab_combine_ref
    from repro_torch.launch.train import build_partition
    from repro_torch.utils.pytree import agent_template

    layout = build_slab_layout(build_partition(state.params), agent_template(state.params))
    slab = layout.pack(state.params)
    K, D = slab.shape
    nb = D // LANES
    g = torch.Generator(device=device).manual_seed(3)
    A = torch.rand(nb, K, K, generator=g, device=device)
    A /= A.sum(1, keepdim=True)
    out = slab_combine(A, slab)
    errs = []
    for b in (0, nb // 2, nb - 1):
        cols = slice(b * LANES, (b + 1) * LANES)
        errs.append(float((out[:, cols] - slab_combine_ref(A[b : b + 1], slab[:, cols].contiguous())).abs().max()))
    assert max(errs) <= MAIN_TOL, errs
    print(f"slab_combine on the full-width slab (K={K}, D={D:,}: {K * D:,} elements, last index past 2^31 "
          f"{(K - 1) * D + D - 1 > 2**31}): first, middle and last column blocks against the plain version "
          f"{[f'{e:.2e}' for e in errs]} (tol {MAIN_TOL})")
    del slab, out, A


# the CLI comparison's probe: each agent's initial weights scaled by 1 +- this
# (sign alternating over the agents).  The card and the CPU differ most in the
# consensus's Gram, f32 sums over a layer segment of up to ~6e5 columns
# (sqrt(6e5) x 2^-24 ~ 2^-14.6 of |x|^2); moving x_k - x_l by 2 x 2^-16 of x
# moves the distances by as much
TRAIN_PROBE = 2.0**-16


def _run_train_cli(argv, device, probe=False):
    """``python -m repro_torch.launch.train`` with ``argv`` on ``device``
    (``train.main``), its JSONL records read back; with ``probe`` the
    initial weights of agent k are scaled by ``1 + (-1)^k TRAIN_PROBE``."""
    import tempfile

    from repro_torch import obs
    from repro_torch.launch import train
    from repro_torch.utils.pytree import tree_map

    init = train.init_train_state

    def moved(x):
        sign = 1.0 - 2.0 * (torch.arange(x.shape[0]) % 2).to(x.dtype)
        return x * (1.0 + TRAIN_PROBE * sign.view(-1, *[1] * (x.dim() - 1)))

    if probe:
        train.init_train_state = lambda *a, **kw: (lambda st: st._replace(params=tree_map(moved, st.params)))(
            init(*a, **kw))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "m.jsonl")
            r = train.main([*argv, "--device", str(device), "--metrics-jsonl", path])
            r["records"] = obs.read_jsonl(path)
    finally:
        train.init_train_state = init
    return r


def _cli_card_vs_cpu(device):
    """The train CLI at ``qwen3-8b-smoke`` (f32), K = 4, seq 64, 2 steps,
    from the same weights on the card and on the CPU, for each of
    TRAIN_CLI: the card's launches a step as stated; losses, parameters
    and every JSONL field held to the CPU's.  The CLI starts every agent
    from one init (as the reference's does), so DRT's Gram-derived
    distances and the weights made from them are badly conditioned, and
    the card's f32 sums in another order move them: each bound is 8 times
    what the TRAIN_PROBE move of the initial weights moves the CPU's own
    run (never under MAIN_TOL for parameters and 1e-5 for losses, TEL_RTOL
    of the field for telemetry); the int8 wire allows one quantization
    step a coded round (2) of the largest power of two over |parameter|;
    wire bytes, edges and rounds run exactly."""
    from repro_torch.utils.pytree import tree_items

    steps = 2
    base = ["--arch", "qwen3-8b-smoke", "--agents", "4", "--seq", "64", "--steps", str(steps)]
    cpu = torch.device("cpu")
    out = {}
    for label, flags, per_step in TRAIN_CLI:
        argv = [*base, *flags]
        _reset_counters()
        card = _run_train_cli(argv, device)
        c = _counters()
        got = _check_launches(f"train cli {label}", c, dict(
            flash_attention=4 * 2 * steps, flash_attention_bwd=4 * 2 * steps * 3,
            **{k: v * steps for k, v in per_step.items()}), True)
        want, nudged = _run_train_cli(argv, cpu), _run_train_cli(argv, cpu, probe=True)
        params = {p: (a.cpu(), b, n) for (p, a), (_, b), (_, n) in zip(
            tree_items(card["state"].params), tree_items(want["state"].params), tree_items(nudged["state"].params))}
        err = max(float((a - b).abs().max()) for a, b, _ in params.values())
        sens = max(float((n - b).abs().max()) for _, b, n in params.values())
        top = 2.0 ** math.ceil(math.log2(max(float(b.abs().max()) for _, b, _ in params.values())))
        bound = max(steps * 1.01 * top / 127 if "int8" in flags else MAIN_TOL, 8 * sens)
        assert err <= bound, (label, err, bound)
        loss_err = max(abs(a - b) for a, b in zip(card["losses"], want["losses"]))
        loss_sens = max(abs(a - b) for a, b in zip(nudged["losses"], want["losses"]))
        loss_bound = max(1e-5, 8 * loss_sens)
        assert loss_err <= loss_bound, (label, loss_err, loss_bound)
        assert len(card["records"]) == len(want["records"]) == steps
        worst = (0.0, "", 0.0)
        for rc, rw, rn in zip(card["records"], want["records"], nudged["records"]):
            assert (rc["step"], rc["round"]) == (rw["step"], rw["round"])
            for name in TEL_EXACT + TEL_WEIGHT + ("disagreement", "layer_d2_mean", "layer_d2_max", "ef_residual",
                                                   "momentum_norm"):
                a, b, n = (np.asarray(r[name], np.float64) for r in (rc, rw, rn))
                e = float(np.abs(a - b).max()) if a.size else 0.0
                if name in TEL_EXACT:
                    assert e == 0.0, (label, name, a, b)
                    continue
                fb = max(TEL_RTOL * float(np.abs(b).max()) if b.size else 0.0,
                         8 * (float(np.abs(n - b).max()) if b.size else 0.0))
                assert e <= fb, (label, name, e, fb)
                if fb and e / fb > worst[0]:
                    worst = (e / fb, name, fb)
        out[label] = card
        print(f"train cli card vs cpu, {label}: launches {got}; losses card {[round(x, 5) for x in card['losses']]} "
              f"vs cpu {loss_err:.3e} (bound {loss_bound:.3e}); parameters {err:.3e} (bound {bound:.3e}, probe "
              f"{sens:.3e}); every JSONL field within its bound (closest: {worst[1]} at {worst[0]:.2f} of "
              f"{worst[2]:.3e}); card {card['seconds']:.2f} s, cpu {want['seconds']:.2f} s", flush=True)
    return out


def phase_lm_train(device):
    """Decentralized LM training (``repro_torch.launch.train``): the
    backward kernel's checks and times (:func:`_bwd_kernel_checks`), the
    full-width qwen3-4b steps (:func:`_full_width_train`) and the CLI card
    against CPU (:func:`_cli_card_vs_cpu`).  Returns ``(kernel row,
    launches of the full-width steps)``."""
    import gc

    t_phase = time.perf_counter()
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    row = _bwd_kernel_checks(device, flush_buf.zero_)
    del flush_buf
    gc.collect()
    torch.cuda.empty_cache()
    counts = _full_width_train(device)
    gc.collect()
    torch.cuda.empty_cache()
    _cli_card_vs_cpu(device)
    print(f"lm train phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row, counts


def _kernel_category(name):
    if any(t in name for t in ("flash_attention_bf16_kernel", "flash_attention_f32_kernel", "selective_scan_kernel",
                               "delta_kernel", "dkdv_kernel", "dq_kernel", "slab_combine_kernel")):
        return "port kernel"
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "Gemm")):
        return "cuBLAS matmul"
    if "copy" in name:
        return "copy / dtype cast"
    return "other elementwise and reductions"


def _profile_window(label, fn):
    """``torch.profiler`` over one ``fn()`` to a device sync: the device
    activities (kernels, copies, sets; not the host-side "Command Buffer
    Full" marker), their time by category and the top 10 by name, and the
    device's busy share (the union of their intervals) of the host-clock
    window, which includes the profiler's own host cost, so the share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    print(f"profile {label}: host-clock window {wall_ms:.1f} ms (profiled), device activities "
          f"{len(spans)} taking {dev_ms:.1f} ms, busy {busy_us / 1e3:.1f} ms = "
          f"{busy_us / 1e3 / wall_ms:.2f} of the window")
    for cat, ms in sorted(by_cat.items(), key=lambda x: -x[1]):
        print(f"  {ms:9.2f} ms {100 * ms / max(dev_ms, 1e-9):5.1f}%  {cat}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda x: -x[1][1])[:10]:
        print(f"    {ms:9.2f} ms x{n:<5d} {name[:100]}")


def phase_serve_profile(device, decode_steps=8):
    """Where the serve path's device time goes.  For each LM at full size
    (batch 4, prompt 2048), one warm prefill, then ``torch.profiler`` over
    one prefill and over ``decode_steps`` greedy decode steps.  Counts device activities only (kernels, copies, sets; not
    the host-side "Command Buffer Full" marker): their time by category and
    the top 10 by name, and the device's busy share (the union of their
    intervals) of the host-clock window, which includes the profiler's own
    host cost, so the share is a lower bound (:func:`_profile_window`)."""
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
                _profile_window(f"{arch} {stage}", fn)
        del params, state
        torch.cuda.empty_cache()


# -- slice 6: the kernel API, the per-slot and fused int8 combines, the tree oracle --------


# The kernel table's readings (PERF.md section 6) of the api kernels, printed
# beside this run's times.
TABLE_MS = {"weighted_combine": 0.0286, "dequant_combine": 0.0284, "int8_quantize": 0.0281,
            "int8_dequantize": 0.0152, "slab_dequant_combine": 0.0327}


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
    launch over the 11 layer slots), ``dequant_combine_slab_kernels`` (one
    ``slab_dequant_combine``), ``dequant_combine_slab_per_slot`` (one
    ``dequant_combine`` launch over the 68 (slot, leaf) pieces), and
    ``int8_quantize`` then ``int8_dequantize`` on each layer segment.  Then,
    outside the counted run, each result against its whole-slab partner and
    its plain version, and ``torch.profiler`` over 10 more calls of each
    per-slot combine: every device operation it records is the combine
    kernel (no copy, multiply or memset), with the counters' one launch a
    call; and the same over 10 calls of ``dequant_combine_slab_kernels``:
    its one kernel, no gather of the per-block matrices, no id check.
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
    want = {"weighted_combine": consensus.COMBINE_PER_SLOT_LAUNCHES, "slab_dequant_combine": 1,
            "dequant_combine": consensus.DEQUANT_PER_SLOT_LAUNCHES, "int8_quantize": L, "int8_dequantize": L}
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
    for label, kernel, fn in (
            ("combine_slab_per_slot", "combine_segments_kernel",
             lambda: consensus.combine_slab_per_slot(layout, A, slab)),
            ("dequant_combine_slab_per_slot", "combine_segments_kernel",
             lambda: consensus.dequant_combine_slab_per_slot(layout, A_off, wire)),
            ("dequant_combine_slab_kernels", "slab_dequant_combine_kernel",
             lambda: consensus.dequant_combine_slab_kernels(layout, A_off, wire))):
        ops = _device_ops(fn)
        print(f"{label}: device operations recorded over 10 calls (torch.profiler: kernels, copies, memsets): "
              f"{dict(collections.Counter(ops))}")
        assert len(ops) >= 5 and all(kernel in op for op in ops), ops
    return {k: c[k] for k in want}


def _device_ops(fn, reps=10):
    """The names of the device operations (kernels, copies, memsets) that
    ``torch.profiler`` records over ``reps`` calls of ``fn()``, in order
    (each call queued behind a device sleep, whose own kernel is left out),
    after one call under a profiler of its own to start the tracer.  In a
    process that has profiled before, the tracer can miss a window's first
    few operations: the caller counts what it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(reps):
            torch.cuda._sleep(QUEUE_CYCLES)
            fn()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
    return [name for _, name in events]


def phase_api_kernels(device):
    """The five kernels of slice 6 against their plain versions at the main
    path's shapes (every call ``phase_api_path`` makes) and at small ragged
    shapes (K = 3, 5, 64; widths that are not a multiple of the block; bf16
    sources for ``weighted_combine``, f32/bf16/f16 for ``int8_quantize``);
    then the times (median of 50, L2 flushed, device time) of the kernel,
    its plain version and, where one exists, the library call.  Returns the
    JSON entries (launches filled in later)."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.combine import (
        segment_table,
        weighted_combine,
        weighted_combine_ref,
        weighted_combine_segments,
        weighted_combine_segments_ref,
    )
    from repro_torch.core import consensus
    from repro_torch.kernels.slab_combine import MAX_AGENTS, slab_dequant_combine, slab_dequant_combine_ref

    layout, slab, A, A_off, wire, u = _api_state(device)
    K, D = slab.shape
    L = layout.num_layers
    rng = np.random.default_rng(16)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    errs = dict.fromkeys(("weighted_combine", "dequant_combine", "int8_quantize", "int8_dequantize"), 0.0)
    # the per-slot combines, one launch each, against their plain versions
    t_slots, t_leaves = layout.segment_table_on("slots", device), layout.segment_table_on("leaves", device)
    W_slot, W_off = A.transpose(1, 2), A_off.transpose(1, 2)
    per_slot = weighted_combine_segments(W_slot, slab, t_slots)
    per_piece = qz.dequant_combine_segments(W_off, wire.s, wire.q, t_leaves)
    torch.cuda.synchronize()
    errs["weighted_combine"] = err(per_slot, weighted_combine_segments_ref(W_slot, slab, t_slots))
    errs["dequant_combine"] = err(per_piece, qz.dequant_combine_segments_plain(W_off, wire.s, wire.q, t_leaves))
    # and every single call of the routes they replace
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
    print(f"the {L} layer slots (weighted_combine, M = N = {K}, rows {D} apart) and the {len(pieces)} "
          f"(slot, leaf) pieces (dequant_combine), each in one launch and each as a single call, "
          f"int8_quantize / int8_dequantize per layer segment: max |kernel - plain| {errs}")
    assert all(e == 0.0 for e in errs.values()), errs
    old_slot, old_piece = _old_per_slot_routes(layout, slab, A, A_off, wire)
    assert torch.equal(old_slot(), per_slot) and torch.equal(old_piece(), per_piece), "one launch vs the old routes"
    for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
        assert torch.all(per_piece[:, s0 + size : e0] == 0), "lane padding must stay exactly zero"
    # segments that start and end off every 4-column boundary, one column wide,
    # across tile edges, with gaps (written 0); rows an odd number apart
    segs = [(1, 3, 2, 1), (7, 500, 0, 4), (509, 6, 3, 0), (530, 1, 1, 2), (600, 2437, 2, 3), (3039, 61, 0, 1)]
    table = segment_table(segs, 3300, device)
    for k_, m_, pad in [(K, K, 0), (5, 3, 3), (MAX_AGENTS, 17, 0), (2, 7, 1)]:
        W = t(np.ascontiguousarray(rng.dirichlet(np.ones(k_), size=(4, m_)).astype(np.float32).swapaxes(1, 2)))
        W = W.transpose(1, 2)
        sc = t(rng.uniform(0.001, 0.02, size=(k_, 6)).astype(np.float32))
        q = t(rng.integers(-127, 128, size=(k_, 3300 + pad)).astype(np.int8))[:, pad:]
        out_q = qz.dequant_combine_segments(W, sc, q, table)
        torch.cuda.synchronize()
        assert torch.equal(out_q, qz.dequant_combine_segments_plain(W, sc, q, table)), (k_, m_, pad)
        for dt in (torch.float32, torch.bfloat16):
            x = t(rng.normal(size=(k_, 3300 + pad)).astype(np.float32)).to(dt)[:, pad:]
            out = weighted_combine_segments(W, x, table)
            torch.cuda.synchronize()
            assert torch.equal(out, weighted_combine_segments_ref(W, x, table)), (k_, m_, pad, dt)
    print("weighted_combine and dequant_combine over unaligned, ragged segments (K = 16, 5, 64, 2; M != N; "
          "odd row strides; f32 and bf16 sources): bit for bit, one launch each")
    A_blocks = A_off[layout.block_layer_on(device)].contiguous()
    col_seg, block_map = layout.maps_on(device)["col_seg"], layout.maps_on(device)["block_layer"]
    sdc = slab_dequant_combine(A_blocks, wire.s, col_seg, wire.q)
    sdc_map = slab_dequant_combine(A_off, wire.s, col_seg, wire.q, block_map)
    torch.cuda.synchronize()
    e_sdc = float((sdc - slab_dequant_combine_ref(A_blocks, wire.s, col_seg, wire.q)).abs().max())
    groups = col_seg.view(-1, 4)
    mixed = int((groups != groups[:, :1]).any(dim=1).sum())
    print(f"slab_dequant_combine K={K} nb={layout.n_blocks}: max |kernel - plain| {e_sdc:.3e} (tol {MAIN_TOL}); "
          f"the (L, K, K) stack through the block map bit for bit with A_blocks: {torch.equal(sdc, sdc_map)}; "
          f"four-column groups with mixed scale segments: {mixed} of {groups.shape[0]}")
    assert e_sdc <= MAIN_TOL and torch.equal(sdc, sdc_map)

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
    # (K, 600) and (64, 200) scales: over what the kernel stages in shared memory
    for k, nb, n_segs in [(3, 1, 1), (5, 7, 4), (1, 4, 3), (K, 5, 9), (MAX_AGENTS, 3, 2), (K, 5, 600),
                          (MAX_AGENTS, 3, 200)]:
        a = t(np.ascontiguousarray(rng.dirichlet(np.ones(k), size=(nb + 2, k)).swapaxes(1, 2), np.float32))
        bmap = t(rng.integers(0, nb + 2, nb).astype(np.int32))
        s = t(rng.uniform(0.001, 0.02, size=(k, n_segs)).astype(np.float32))
        seg = t(np.sort(rng.integers(0, n_segs, nb * 128)).astype(np.int32))  # ids change inside groups
        q = rng.integers(-127, 128, size=(k, nb * 128)).astype(np.int8)
        q.reshape(k, nb, 128)[:, :, -3:] = 0
        q = t(q)
        out = slab_dequant_combine(a[bmap.long()].contiguous(), s, seg, q)
        out_map = slab_dequant_combine(a, s, seg, q, bmap)
        torch.cuda.synchronize()
        assert float((out - slab_dequant_combine_ref(a, s, seg, q, bmap)).abs().max()) <= MAIN_TOL, (k, nb)
        assert torch.equal(out, out_map) and torch.all(out.view(k, nb, 128)[:, :, -3:] == 0), (k, nb)
    # int8_quantize at ragged lengths, on views 0-3 elements off a 16-byte
    # boundary (its per-element path) and at the clip (x = +-absmax, u near 1)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        xb = t(rng.normal(size=4110).astype(np.float32)).to(dt)
        ub = t(rng.uniform(size=4110).astype(np.float32))
        for n in (1, 15, 16, 17, 4099):
            for off in (0, 1, 3):
                for x, uu in ((xb[off : off + n], ub[:n]), (xb[:n], ub[off : off + n])):
                    qq, ss = qz.int8_quantize(x, uu)
                    torch.cuda.synchronize()
                    assert torch.equal(qq, qz.int8_quantize_plain(x, uu, ss)), (dt, n, off)
        x = t(np.array([1.5, -1.5, 0.25, -0.75] * 9, np.float32)).to(dt)
        uu = t(np.array([np.nextafter(np.float32(1), np.float32(0)), 0.0] * 18, np.float32))
        qq, ss = qz.int8_quantize(x, uu)
        torch.cuda.synchronize()
        assert torch.equal(qq, qz.int8_quantize_plain(x, uu, ss)) and (int(qq.max()), int(qq.min())) == (127, -127)
    # int8_dequantize at the same lengths and offsets (a view off a 16-byte
    # boundary takes its per-element path), one launch a call
    qb = t(rng.integers(-128, 128, size=4110).astype(np.int8))
    sb = t(np.array(rng.uniform(0.001, 0.02), np.float32))
    for n in (1, 15, 16, 17, 4099):
        for off in (0, 1, 3):
            before = qz.int8_dequantize.launches
            dd = qz.int8_dequantize(qb[off : off + n], sb)
            torch.cuda.synchronize()
            assert qz.int8_dequantize.launches == before + 1
            assert torch.equal(dd, qz.int8_dequantize_plain(qb[off : off + n], sb)), (n, off)
    print("api kernels at small shapes (K = 1, 3, 5, 16, 64; ragged widths; f32, bf16, f16): weighted_combine, "
          "dequant_combine, int8_quantize, int8_dequantize bit for bit, slab_dequant_combine within tolerance "
          "(its block-map route bit for bit with A_blocks); int8_quantize at lengths 1, 15, 16, 17, 4099, on "
          "views 1 and 3 elements off alignment and at the clip, int8_dequantize at the same lengths and "
          "offsets (one launch a call): bit for bit")

    # times at the main path's shapes, over the whole slab as the path runs it.
    # int8_quantize's kernel is timed without the scale's torch reduction
    # (int8_round; the whole call is timed beside it): each bound counts the
    # kernel's own bytes.  slab_dequant_combine's segment-id check ran at its
    # first call above (it runs once per map tensor).
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    scale = qz.int8_scale(slab)
    q_all = qz.int8_quantize(slab, u)[0]
    s0 = wire.s[0, 0].contiguous()
    d_all = qz.int8_dequantize(q_all, s0)
    torch.cuda.synchronize()
    assert torch.equal(d_all, qz.int8_dequantize_plain(q_all, s0)), "int8_dequantize on the whole slab"
    del d_all
    n_in = sum(w for _, w, _, _ in t_leaves.segments)  # the columns the int8 combine reads
    x3 = slab.view(K, -1, layout.lane)
    A_blocks_all = A[layout.block_layer_on(device)].contiguous()
    runs = {  # name: (kernel, plain, library or None, bytes, operations)
        "weighted_combine": (
            lambda: weighted_combine_segments(W_slot, slab, t_slots),
            lambda: weighted_combine_segments_ref(W_slot, slab, t_slots),
            lambda: torch.einsum("blk,lbc->kbc", A_blocks_all, x3),
            4 * (2 * K * D + L * K * K) + 32 * t_slots.tiles.shape[0], 2 * K * K * D,
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
            lambda: qz.dequant_combine_segments(W_off, wire.s, wire.q, t_leaves),
            lambda: qz.dequant_combine_segments_plain(W_off, wire.s, wire.q, t_leaves),
            None, K * n_in + 4 * K * D + 4 * (L * K * K + wire.s.numel()) + 32 * t_leaves.tiles.shape[0],
            2 * K * K * n_in,
        ),
        "slab_dequant_combine": (
            lambda: slab_dequant_combine(A_blocks, wire.s, col_seg, wire.q),
            lambda: slab_dequant_combine_ref(A_blocks, wire.s, col_seg, wire.q),
            None, K * D + 4 * D + 4 * (A_blocks.numel() + wire.s.numel()) + 4 * K * D, 2 * K * K * D + K * D,
        ),
    }
    lib_name = {"weighted_combine": "torch.einsum over the per-block matrices", "int8_dequantize": "q * s"}
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
              f"achieved {n_bytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.0%} of the bound; "
              f"the kernel table's earlier reading {TABLE_MS[name]} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source.get(name, 'quantize.cu')}",
            "replaces": f"src/repro/kernels/{replaces[name]}", "launches": None,
            "max_abs_err": e_sdc if name == "slab_dequant_combine" else errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    # beside them: int8_quantize's whole call (the reduction and the rounding)
    # and slab_dequant_combine as the slab path calls it (the stack and the map)
    path_bytes = K * D + 4 * D + 4 * (A_off.numel() + wire.s.numel() + layout.n_blocks) + 4 * K * D
    for label, fn, n_bytes in (
            ("int8_quantize whole call (int8_scale's reduction, then int8_round)",
             lambda: qz.int8_quantize(slab, u), None),
            ("dequant_combine_slab_kernels (slab_dequant_combine through the (L, K, K) stack and the block map)",
             lambda: consensus.dequant_combine_slab_kernels(layout, A_off, wire), path_bytes)):
        fn()
        ms = _ms_median(fn, 50, flush)
        bound = ""
        if n_bytes is not None:
            bound_ms, _ = _bound(n_bytes, 2 * K * K * D + K * D)
            bound = f"; bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, bytes), {bound_ms / ms:.0%} of the bound"
        print(f"{label} timing (median, L2 flushed, device time): {ms:.4f} ms{bound}")
    # the zero_ flush leaves ~50 MB of dirty lines in L2 for the timed call to
    # write back; behind a read-only flush they are clean.  Beside the two
    # kernels there, a 4-byte fill of the (K, D) f32 output and slab.clone()
    ones = torch.ones(64 * 2**20, device=device)
    out_f32 = torch.empty(K, D, device=device)
    clean = {label: _ms_median(fn, 50, ones.sum) for label, fn in (
        ("int8_round", runs["int8_quantize"][0]), ("slab_dequant_combine", runs["slab_dequant_combine"][0]),
        (f"a 4-byte fill of the ({K}, {D}) f32 output", lambda: out_f32.fill_(1.0)), ("slab.clone()", slab.clone))}
    print("with a read-only L2 flush (median of 50, device time, ms): "
          + "; ".join(f"{k} {v:.4f}" for k, v in clean.items()))
    del ones, out_f32
    time_int8_dequantize(q_all, s0)
    _time_per_slot_routes(layout, slab, A, A_off, wire, runs, flush)
    _combine_sass_report()
    _api_sass_report()
    return entries


def time_int8_dequantize(q, s, reps=50):
    """``int8_dequantize(q, s)`` (one ``(K, D)`` int8 tensor, one scale)
    behind each flush, the ``zero_`` one (it leaves dirty lines in L2 that
    the timed call writes back) and a read-only one (a sum over 256 MB),
    beside a 4-byte fill of its f32 output and ``q * s``.  Median device ms
    of ``reps`` calls each, the bound beside them.  Returns the times by
    (flush, label)."""
    from repro_torch.kernels import quantize as qz

    device = q.device
    out = torch.empty(q.shape, device=device)
    flushes = {"zero_": torch.empty(256 * 2**20, dtype=torch.uint8, device=device).zero_,
               "read-only": torch.ones(64 * 2**20, device=device).sum}
    runs = {"int8_dequantize": lambda: qz.int8_dequantize(q, s),
            f"a 4-byte fill of the {tuple(q.shape)} f32 output": lambda: out.fill_(1.0),
            "q * s": lambda: q * s}
    got = {}
    for fname, flush in flushes.items():
        for label, fn in runs.items():
            fn()
            got[fname, label] = _ms_median(fn, reps, flush)
    bound_ms, _ = _bound(5 * q.numel() + 4, q.numel())
    for fname in flushes:
        print(f"int8_dequantize {tuple(q.shape)} behind the {fname} flush (median of {reps}, device time, ms; "
              f"bound {bound_ms:.4f}): " + "; ".join(f"{k} {v:.4f}" for (f, k), v in got.items() if f == fname))
    return got


def _old_per_slot_routes(layout, slab, A, A_off, wire):
    """The two per-slot combines as the path ran them before each became one
    launch, through the single-call API: one ``weighted_combine`` per layer
    slot with its transpose copy and a copy of its result into the output;
    into a zeroed output, one ``dequant_combine`` per (slot, leaf) with its
    slot's transpose, its scale column's copy, the torch multiply ``a *
    scales`` the wrapper made then (here by the caller, the kernel's own
    scales then 1: the same f32 bits) and a copy of its result.  Returns the
    two routes as functions."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.combine import weighted_combine

    K, D = slab.shape
    ones = torch.ones(K, device=slab.device)

    def old_slot():
        out = torch.empty_like(slab)
        for p, (s0, e0) in enumerate(layout.layer_slices):
            out[:, s0:e0] = weighted_combine(A[p].T.contiguous(), slab[:, s0:e0])
        return out

    def old_piece():
        out = torch.zeros(K, D, device=slab.device)
        for grp in layout.groups:
            for j in range(grp.n_slots):
                W = A_off[grp.layer0 + j].T.contiguous()
                base = grp.col0 + j * grp.s_pad
                for plan in grp.leaves:
                    sid = plan.scale_seg0 + (j if plan.scale_per_slot else 0)
                    c = slice(base + plan.col0, base + plan.col0 + plan.width)
                    out[:, c] = qz.dequant_combine(W * wire.s[:, sid].contiguous(), ones, wire.q[:, c])
        return out

    return old_slot, old_piece


def _time_per_slot_routes(layout, slab, A, A_off, wire, runs, flush):
    """Beside the one-launch per-slot calls (timed in ``runs``), in the same
    run: the old per-piece routes (:func:`_old_per_slot_routes`), 11
    ``torch.matmul`` s (one a slot), and one single API call at the largest
    slot (M = N = 16) and at the smallest piece, of each kernel.  Asserts
    that each one-launch call beats its old route."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.combine import weighted_combine

    old_slot, old_piece = _old_per_slot_routes(layout, slab, A, A_off, wire)
    slots = [(A[p].T.contiguous(), slab[:, s:e]) for p, (s, e) in enumerate(layout.layer_slices)]
    Wb, xb = max(slots, key=lambda wx: wx[1].shape[1])
    pieces = _dequant_pieces(layout, A_off, wire)
    Ws, ss, qs = min(pieces, key=lambda wsq: wsq[2].shape[1])
    Wq, sq, qq = max(pieces, key=lambda wsq: wsq[2].shape[1])
    xs = slab[:, :qs.shape[1]]
    timed = {
        "weighted_combine one launch": runs["weighted_combine"][0],
        f"weighted_combine old route ({len(slots)} calls, transposes, copies)": old_slot,
        f"torch.matmul x{len(slots)}": lambda: [torch.matmul(W, x) for W, x in slots],
        f"weighted_combine single call, largest slot ({xb.shape[1]} columns)": lambda: weighted_combine(Wb, xb),
        f"weighted_combine single call, {xs.shape[1]} columns": lambda: weighted_combine(Wb, xs),
        "dequant_combine one launch": runs["dequant_combine"][0],
        f"dequant_combine old route ({len(pieces)} calls and multiplies, {len(pieces)} scale copies, "
        f"{len(pieces)} copies, {len(slots)} transposes, a memset)": old_piece,
        f"dequant_combine single call, largest piece ({qq.shape[1]} columns)": lambda: qz.dequant_combine(Wq, sq, qq),
        f"dequant_combine single call, smallest piece ({qs.shape[1]} columns)": lambda: qz.dequant_combine(Ws, ss, qs),
    }
    got = {}
    for label, fn in timed.items():
        fn()
        got[label] = _ms_median(fn, 20 if "old route" in label else 50, flush)
    print("per-slot combines and their single calls (median, L2 flushed, device time, ms): "
          + "; ".join(f"{k} {v:.4f}" for k, v in got.items()))
    for name in ("weighted_combine", "dequant_combine"):
        one, old = (v for k, v in got.items() if k.startswith(name) and ("one launch" in k or "old route" in k))
        assert one < old, (name, one, old)


def _combine_sass_report():
    """The combine kernels' SASS (``cuobjdump``): in the 16-output-row f32
    and int8 instantiations, the straight run of code with the most ``FMUL``
    (one source's products for a thread's four columns and 16 rows), its
    instructions per product (a product is one ``FMUL`` and its ``FADD``;
    the int8 widening adds an ``FADD`` an element)."""
    for lib, head, label in (("combine", "combine_segments_kernelIffLb0ELi16E", "f32"),
                             ("quantize", "combine_segments_kernelIafLb1ELi16E", "int8")):
        loop = max(_straight_runs(_sass_body(_sass(lib), head)), key=lambda c: c["FMUL"])
        n = loop["FMUL"]
        assert n > 0, (label, loop)
        print(f"SASS combine_segments_kernel {label}, 16 rows: {sum(loop.values())} instructions for {n} products "
              f"({sum(loop.values()) / n:.3f} a product): {dict(loop.most_common())}")


def _api_sass_report():
    """The SASS (``cuobjdump``) of the two kernels redesigned around wide
    accesses and register-held sources: ``int8_quantize_kernel<float,
    int>`` must hold 16-byte loads and stores (``LDG.E.128``,
    ``STG.E.128``); in ``slab_dequant_combine_kernel<16, scales in shared
    memory>``, the straight run with the most ``FFMA`` (the one pass over
    all 16 sources for a thread's 4 columns and 16 output rows; of such
    runs the one with the fewest shared-memory loads, the path where a
    group's four segment ids agree): its FFMAs per shared-memory load
    (``LDS*``), under one load per four FFMA (asserted), and its
    instructions per product (one ``FFMA`` a product)."""
    for head, label in (("int8_quantize_kernelIfiE", "int8_quantize_kernel<float,int>"),
                        ("int8_dequantize_kernelIiE", "int8_dequantize_kernel<int>")):
        ops = collections.Counter(_SASS_OP.findall(_sass_body(_sass("quantize"), head)))
        mem = {op: n for op, n in ops.items() if op.startswith(("LDG", "STG"))}
        print(f"SASS {label} global loads and stores: {mem}")
        assert any(op.startswith("LDG.E.128") for op in mem) and any(op.startswith("STG.E.128") for op in mem), mem
    # int8_dequantize: the straight run with the most FMUL, one guarded
    # 16-byte store of four elements (a step is four)
    run = max(_straight_runs(_sass_body(_sass("quantize"), "int8_dequantize_kernelIiE")), key=lambda c: c["FMUL"])
    print(f"SASS int8_dequantize_kernel<int> straight run of one store ({run['FMUL']} elements): "
          f"{sum(run.values())} instructions ({sum(run.values()) / max(run['FMUL'], 1):.3f} an element): "
          f"{dict(run.most_common())}")
    runs = _straight_runs(_sass_body(_sass("slab_combine"), "slab_dequant_combine_kernelILi16ELb1EE"))

    def lds(c):
        return sum(n for op, n in c.items() if op.startswith("LDS"))

    run = max(runs, key=lambda c: (c["FFMA"], -lds(c)))
    n, k, total = run["FFMA"], lds(run), sum(run.values())
    print(f"SASS slab_dequant_combine_kernel<16,1>: {total} instructions for {n} products ({total / n:.3f} a "
          f"product), {k} shared-memory loads ({n / max(k, 1):.1f} FFMA a load): {dict(run.most_common())}")
    assert n > 0 and 4 * k < n, run


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
    for name, n in phase_control(device).items():
        launches[name] += n
    for name, n in phase_faults(device).items():
        launches[name] += n
    for name, n in phase_telemetry(device).items():
        if name in launches:
            launches[name] += n
    phase_tree_oracle(device)
    launches.update(phase_serve(device))
    phase_serve_profile(device)
    train_row, train_counts = phase_lm_train(device)
    kernels.append(train_row)
    for name, n in train_counts.items():
        launches[name] = launches.get(name, 0) + n
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
