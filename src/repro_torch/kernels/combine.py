"""The weighted neighbour combine: ``out = sum_n a[n] * xs[n]``.

``weighted_combine(a, xs)`` takes ``a`` (N,) f32 and ``xs`` (N, ...) f32 or
bf16 and returns an ``xs[0]``-shaped tensor in ``xs``'s dtype, accumulated
in f32.  A batched call takes ``a`` (M, N), one weight row per output, and
returns (M, ...) in ONE launch: the reference's per-slot consensus combine
runs the TPU kernel under ``jax.vmap`` over the output agents, which is
that call with ``M = K`` (``repro_torch.core.consensus.combine_slab_per_slot``).

It replaces the Pallas TPU kernel ``repro/kernels/combine.py``
``weighted_combine``.  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/combine.cu`` (built with nvcc for
sm_90a, bound with ctypes) or raises; on a CPU tensor it runs
:func:`weighted_combine_ref`, the plain PyTorch version.  There is no
fallback from one to the other.  Both sum over n in the Pallas body's
order and round product and sum apart, so they agree bit for bit.

The rows of ``xs`` need not be adjacent: ``xs[0]`` must be contiguous, and
the rows may sit any stride apart (a column slice of a slab goes in without
a copy).  The kernel is bound by device memory (see the source note).

``weighted_combine.launches`` counts kernel launches (CPU calls do not
count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.counters import bump

MAX_SOURCES = 64  # largest N the kernel takes (csrc/combine_rows.cuh kMaxSources)
DTYPES = (torch.float32, torch.bfloat16)


def weighted_combine_ref(a: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_combine`: the kernel's
    ordered loop over the sources, one rounded product and one rounded sum
    per source, then the cast to ``xs``'s dtype."""
    w, x, shape = _rows(a, xs)
    acc = w[:, :1] * x[0]
    for n in range(1, x.shape[0]):
        acc = acc + w[:, n : n + 1] * x[n]
    return acc.to(xs.dtype).reshape(shape)


def weighted_combine(a: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``sum_n a[n] * xs[n]`` (``a`` (N,)) or, batched, ``out[m] = sum_n
    a[m, n] * xs[n]`` (``a`` (M, N)): ONE kernel launch on CUDA tensors,
    :func:`weighted_combine_ref` on CPU tensors."""
    _check(a, xs)
    if xs.device.type == "cpu":
        return weighted_combine_ref(a, xs)
    if xs.device.type != "cuda":
        raise ValueError(f"weighted_combine runs on CPU or CUDA tensors, got {xs.device}")
    if xs.dtype not in DTYPES or a.dtype != torch.float32:
        raise TypeError(
            f"the weighted_combine kernel takes f32 weights and f32 or bf16 sources, got a "
            f"{a.dtype} and xs {xs.dtype}"
        )
    N = xs.shape[0]
    if not 1 <= N <= MAX_SOURCES:
        raise ValueError(f"the weighted_combine kernel takes 1..{MAX_SOURCES} sources, got N={N}")
    n = xs[0].numel()
    ldx = xs.stride(0) if N > 1 else n
    if not (a.is_contiguous() and xs[0].is_contiguous()) or ldx < n:
        raise ValueError("the weighted_combine kernel needs contiguous weights and disjoint "
                         "contiguous source rows")
    w = a.reshape(-1, N)
    M = w.shape[0]
    out = torch.empty((M, n), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = _kernel()(w.data_ptr(), xs.data_ptr(), out.data_ptr(), M, N, n, ldx,
                        int(xs.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"weighted_combine kernel launch failed: CUDA error {err}")
    bump(weighted_combine)
    return out.reshape(_out_shape(a, xs))


weighted_combine.launches = 0


def _check(a: torch.Tensor, xs: torch.Tensor) -> None:
    if xs.dim() < 1 or a.dim() not in (1, 2) or a.shape[-1] != xs.shape[0]:
        raise ValueError(
            f"weighted_combine needs a (N,) or (M, N) and xs (N, ...), got {tuple(a.shape)} "
            f"and {tuple(xs.shape)}"
        )
    if xs.shape[0] < 1 or xs[0].numel() < 1:
        raise ValueError(f"weighted_combine needs at least one source element, got {tuple(xs.shape)}")
    if a.device != xs.device:
        raise ValueError(f"a on {a.device}, xs on {xs.device}")


def _out_shape(a: torch.Tensor, xs: torch.Tensor) -> tuple:
    return (*a.shape[:-1], *xs.shape[1:])


def _rows(a: torch.Tensor, xs: torch.Tensor):
    """``(w (M, N) f32, x (N, n) f32, output shape)`` of a combine."""
    _check(a, xs)
    N = xs.shape[0]
    return a.float().reshape(-1, N), xs.float().reshape(N, -1), _out_shape(a, xs)


def _kernel():
    from repro_torch.kernels import build

    fn = build.load("combine").weighted_combine_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
