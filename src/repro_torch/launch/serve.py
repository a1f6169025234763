"""Serving entry point: batched prefill, then a greedy (or sampled) decode loop.

    python -m repro_torch.launch.serve --arch qwen3-4b --batch 4 \\
        --prompt-len 2048 --max-new 32 [--seed S] [--temperature T] [--device cpu]

Weights are random (drawn on the device from a ``torch.Generator`` seeded
with ``--seed``, with the reference's distributions); prompt tokens come
from numpy with the same seed, so a test can hand the reference the same
token array.  Runs on CUDA unless ``--device cpu`` is given, and raises
without a GPU.  Prints the prefill seconds, the decode seconds and the
decode tokens per second (host clock around work that ends in a device
sync) and, per stage, the kernel launches (``flash_attention`` for the
attention layers' prefill, ``selective_scan`` for the Mamba layers';
decode runs neither).  The ported archs: ``qwen3-4b``, ``falcon-mamba-7b``
and their ``-smoke`` variants.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.registry import get_bundle
from repro_torch.utils.pytree import tree_leaves

KERNELS = {"flash_attention": flash_attention, "selective_scan": selective_scan}


def build_request_batch(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """Prompt tokens (batch, prompt_len) int64 in [1, min(vocab, 1024))."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, min(cfg.vocab, 1024), size=(batch, prompt_len), dtype=np.int64)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="batched LM serving loop (prefill + decode)")
    ap.add_argument("--arch", default="qwen3-4b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.prompt_len < 1 or args.max_new < 1:
        ap.error("--batch, --prompt-len and --max-new must be >= 1")
    return args


def _launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in _launches().items()}


def run(args: argparse.Namespace) -> dict:
    """Build the model, serve one batch, and report what happened."""
    device = resolve_device(args.device)
    bundle = get_bundle(args.arch)
    cfg = bundle.cfg
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = bundle.init(gen)
    synchronize(device)
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(build_request_batch(cfg, args.batch, args.prompt_len, args.seed)).to(device)
    max_len = args.prompt_len + args.max_new + 1

    def sample(logits):
        last = logits[:, -1].float()
        if args.temperature <= 0:
            return last.argmax(-1, keepdim=True)
        probs = torch.softmax(last / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    with torch.inference_mode():
        before = _launches()
        synchronize(device)
        t0 = time.perf_counter()
        logits, caches, pos = bundle.prefill(params, {"tokens": tokens}, max_len)
        tok = sample(logits)
        synchronize(device)
        prefill_s = time.perf_counter() - t0
        prefill_launches = _since(before)
        finite = bool(torch.isfinite(logits).all())

        before = _launches()
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.max_new - 1):
            logits, caches = bundle.decode_step(params, tok, caches, pos)
            pos += 1
            tok = sample(logits)
            out.append(tok)
        synchronize(device)
        decode_s = time.perf_counter() - t0
        decode_launches = _since(before)
        finite = finite and bool(torch.isfinite(logits).all())

    n_decoded = args.batch * (args.max_new - 1)
    return {
        "arch": args.arch,
        "device": str(device),
        "n_params": sum(x.numel() for x in tree_leaves(params)),
        "init_seconds": init_s,
        "prefill_seconds": prefill_s,
        "decode_seconds": decode_s,
        "decode_tok_per_s": n_decoded / decode_s if decode_s > 0 else float("nan"),
        "launches": {"prefill": prefill_launches, "decode": decode_launches},
        "logits_finite": finite,
        "tokens": torch.cat(out, dim=1).cpu().numpy(),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    r = run(args)
    peak = r["peak_memory_bytes"]
    print(f"arch={r['arch']} device={r['device']} params={r['n_params']:,} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} init={r['init_seconds']:.2f}s "
          f"prefill={r['prefill_seconds']:.3f}s decode={r['decode_seconds']:.3f}s "
          f"({r['decode_tok_per_s']:.1f} tok/s)"
          + (f" peak_mem={peak / 2**30:.2f}GiB" if peak is not None else ""))
    print(f"kernel launches: prefill {r['launches']['prefill']} decode {r['launches']['decode']}")
    print(f"logits finite: {r['logits_finite']}; sample tokens: {r['tokens'][0, :16].tolist()}")
    return r


if __name__ == "__main__":
    main()
