"""Whole-slab per-layer agent mixing: the exact consensus round-set's combine.

``slab_combine(A_blocks, slab)`` computes

    out[k, c] = sum_l A_blocks[c // 128, l, k] * slab[l, c]

for ``A_blocks`` (n_blocks, K, K) f32 and ``slab`` (K, n_blocks * 128) f32:
every 128-column block of the packed slab belongs to one DRT layer
(``SlabLayout.block_layer``) and is mixed by that layer's (K, K) matrix.

It replaces the Pallas TPU kernel ``repro/kernels/slab_combine.py``
``slab_combine``.  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/slab_combine.cu`` (built with nvcc for sm_90a, bound
with ctypes) or raises; on a CPU tensor it runs :func:`slab_combine_ref`,
the plain PyTorch version.  There is no fallback from one to the other.

The kernel is bound by device memory (see the source note): it reads the
slab and A_blocks once and writes the output once.

``slab_combine.launches`` counts kernel launches (CPU calls do not count),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

LANES = 128  # column-block width; SlabLayout pads every layer segment to it
MAX_AGENTS = 64  # largest K the kernel takes (its shared-memory budget)


def slab_combine_ref(A_blocks: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_combine`: one batched matmul over
    the column blocks, ``(nb, K, K)^T x (nb, K, 128)``."""
    K, D = slab.shape
    nb = A_blocks.shape[0]
    x = slab.float().view(K, nb, LANES).transpose(0, 1)  # (nb, K, 128)
    out = torch.bmm(A_blocks.float().transpose(1, 2), x)  # (nb, K, 128)
    return out.transpose(0, 1).reshape(K, D).to(slab.dtype)


def _check(A_blocks: torch.Tensor, slab: torch.Tensor) -> None:
    if slab.dim() != 2 or A_blocks.dim() != 3:
        raise ValueError(
            f"slab_combine needs A_blocks (nb, K, K) and slab (K, D), got "
            f"{tuple(A_blocks.shape)} and {tuple(slab.shape)}"
        )
    K, D = slab.shape
    nb = A_blocks.shape[0]
    if nb * LANES != D:
        raise ValueError(f"slab width {D} != {nb} blocks x {LANES} lanes")
    if tuple(A_blocks.shape[1:]) != (K, K):
        raise ValueError(f"A_blocks must be ({nb}, {K}, {K}), got {tuple(A_blocks.shape)}")
    if A_blocks.device != slab.device:
        raise ValueError(f"A_blocks on {A_blocks.device}, slab on {slab.device}")


def slab_combine(A_blocks: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Whole-slab per-layer agent mixing in ONE kernel launch (CUDA tensors)
    or through :func:`slab_combine_ref` (CPU tensors).  Returns a new
    (K, D) tensor in the slab's dtype."""
    _check(A_blocks, slab)
    if slab.device.type == "cpu":
        return slab_combine_ref(A_blocks, slab)
    if slab.device.type != "cuda":
        raise ValueError(f"slab_combine runs on CPU or CUDA tensors, got {slab.device}")
    if slab.dtype != torch.float32 or A_blocks.dtype != torch.float32:
        raise TypeError(
            f"the slab_combine kernel takes float32 operands, got A_blocks "
            f"{A_blocks.dtype} and slab {slab.dtype}"
        )
    if not (slab.is_contiguous() and A_blocks.is_contiguous()):
        raise ValueError("the slab_combine kernel needs contiguous operands")
    K = slab.shape[0]
    if not 1 <= K <= MAX_AGENTS:
        raise ValueError(f"the slab_combine kernel takes 1..{MAX_AGENTS} agents, got K={K}")
    fn = _kernel()
    out = torch.empty_like(slab)
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        err = fn(
            A_blocks.data_ptr(), slab.data_ptr(), out.data_ptr(),
            K, A_blocks.shape[0], stream,
        )
    if err != 0:
        raise RuntimeError(f"slab_combine kernel launch failed: CUDA error {err}")
    slab_combine.launches += 1
    return out


slab_combine.launches = 0


def _kernel():
    from repro_torch.kernels import build

    lib = build.load("slab_combine")
    fn = lib.slab_combine_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
