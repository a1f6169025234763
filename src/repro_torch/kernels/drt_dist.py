"""Fused DRT distance statistics: the permute engine's neighbour statistics.

``drt_dist(x, y)`` returns ``[sum((x - y)^2), sum(y^2)]`` as a (2,) f32
tensor, for two tensors of one shape (any size >= 1).  The permute
consensus engine calls it once per DRT layer slot and neighbour, with its
own decoded layer segment as ``x`` and the neighbour's as ``y`` (so the
second entry is the NEIGHBOUR's squared norm).

It replaces the Pallas TPU kernel ``repro/kernels/drt_dist.py``
``drt_dist``.  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/drt_dist.cu`` (built with nvcc for sm_90a, bound with
ctypes) or raises; on a CPU tensor it runs :func:`drt_dist_ref`, the plain
PyTorch version.  There is no fallback from one to the other.

The TPU kernel accumulates over a sequential grid; CUDA blocks run in no
order, so a call is :data:`LAUNCHES_PER_CALL` launches: per-block partial
pairs, then one block that sums them in a fixed order (no atomics: two runs
give identical bits).  The plain version sums in torch's order, so the two
agree to a relative tolerance of the sums, not bit for bit.

``drt_dist.launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.counters import bump

LAUNCHES_PER_CALL = 2  # per-block partials, then the fixed-order finalize
THREADS = 256  # threads per block of the partial pass (csrc/drt_dist.cu kThreads)
PER_THREAD = 8  # elements per thread the grid is sized for
MAX_BLOCKS = 1024  # csrc/drt_dist.cu kMaxBlocks


def drt_dist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`drt_dist`."""
    xf, yf = x.float(), y.float()
    d = xf - yf
    return torch.stack([(d * d).sum(), (yf * yf).sum()])


def n_blocks(n: int) -> int:
    """Blocks of the partial pass for ``n`` elements: a function of ``n``
    alone, so the fixed-order sum is the same on every run."""
    return max(1, min(MAX_BLOCKS, -(-n // (THREADS * PER_THREAD))))


def drt_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[sum((x - y)^2), sum(y^2)]`` as (2,) f32: kernel launches on CUDA
    tensors, :func:`drt_dist_ref` on CPU tensors."""
    if x.shape != y.shape:
        raise ValueError(f"drt_dist needs equal shapes, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    n = x.numel()
    if n < 1:
        raise ValueError("drt_dist needs at least one element")
    if x.device.type == "cpu":
        return drt_dist_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"drt_dist runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"the drt_dist kernel takes float32 operands, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the drt_dist kernel needs contiguous operands")
    fn = _kernel()
    nb = n_blocks(n)
    partial = torch.empty(2 * nb, dtype=torch.float32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), n, nb, partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"drt_dist kernel launch failed: CUDA error {err}")
    bump(drt_dist, n=LAUNCHES_PER_CALL)
    return out


drt_dist.launches = 0


def _kernel():
    from repro_torch.kernels import build

    fn = build.load("drt_dist").drt_dist_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
