"""Whole-slab per-layer combines: the gather engine's agent mixing and the
permute engine's source combine.

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

``slab_source_combine(w_blocks, srcs)`` computes

    out[c] = sum_n w_blocks[c // 128, n] * srcs[n, c]

for ``w_blocks`` (n_blocks, N) f32 and ``srcs`` (N, n_blocks * 128) f32: the
permute engine's combine of one agent's own slab and the N - 1 slabs it
received, each 128-column block weighted by its layer's mixing column.  It
replaces the Pallas TPU kernel ``slab_source_combine`` of the same module;
the kernel (``csrc/slab_combine.cu``) and :func:`slab_source_combine_ref`
both sum over n in order and round product and sum apart, so they agree
bit for bit.

``slab_dequant_combine(A_blocks, scales, col_seg, q_slab)`` is the fused
int8 form of ``slab_combine``: the (K, D) int8 wire ``q_slab`` is decoded
column by column (``scales[l, col_seg[c]] * q[l, c]``) inside the kernel and
mixed as ``slab_combine`` mixes, so the decoded f32 slab never reaches
device memory.  It replaces the Pallas TPU kernel ``slab_dequant_combine``
of the same module, which rebuilds the per-column scales with a one-hot
matmul; the CUDA kernel gathers them through ``col_seg``.  Its plain
version :func:`slab_dequant_combine_ref` decodes, then runs
:func:`slab_combine_ref`.

``slab_combine.launches``, ``slab_dequant_combine.launches`` and
``slab_source_combine.launches`` count kernel launches (CPU calls do not
count), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.counters import bump

LANES = 128  # column-block width; SlabLayout pads every layer segment to it
MAX_AGENTS = 64  # largest K the kernel takes (its shared-memory budget)
MAX_SOURCES = 64  # largest N slab_source_combine takes (one weight per thread)


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
    bump(slab_combine)
    return out


slab_combine.launches = 0


def slab_dequant_combine_ref(A_blocks, scales, col_seg, q_slab) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_dequant_combine`: the decoded
    slab ``scales[l, col_seg[c]] * q[l, c]`` (one rounded product, as the
    kernel stages it), then :func:`slab_combine_ref`."""
    seg = col_seg.reshape(-1).long()
    return slab_combine_ref(A_blocks, scales.float()[:, seg] * q_slab.float())


def slab_dequant_combine(A_blocks, scales, col_seg, q_slab) -> torch.Tensor:
    """Fused int8 dequantize + whole-slab combine in ONE kernel launch (CUDA
    tensors) or through :func:`slab_dequant_combine_ref` (CPU tensors):

        out[k, c] = sum_l A_blocks[c // 128, l, k] * scales[l, col_seg[c]] * q[l, c]

    ``A_blocks`` (n_blocks, K, K) f32, ``scales`` (K, n_segs) f32, ``col_seg``
    (n_blocks, 128) or (D,) int32 (the layout's ``col_scale_seg``), ``q_slab``
    (K, D) int8.  Every segment id must lie in ``[0, n_segs)`` (checked: one
    device sync).  Returns a new (K, D) f32 tensor."""
    _check(A_blocks, q_slab)
    K, D = q_slab.shape
    if scales.dim() != 2 or scales.shape[0] != K or col_seg.numel() != D:
        raise ValueError(
            f"slab_dequant_combine needs scales ({K}, n_segs) and col_seg of {D} entries, got "
            f"{tuple(scales.shape)} and {tuple(col_seg.shape)}"
        )
    if not (scales.device == col_seg.device == q_slab.device):
        raise ValueError(f"scales on {scales.device}, col_seg on {col_seg.device}, q on {q_slab.device}")
    lo, hi = (int(v) for v in torch.aminmax(col_seg.reshape(-1)))
    if lo < 0 or hi >= scales.shape[1]:
        raise ValueError(f"col_seg holds segments {lo}..{hi}, scales has {scales.shape[1]}")
    if q_slab.device.type == "cpu":
        return slab_dequant_combine_ref(A_blocks, scales, col_seg, q_slab)
    if q_slab.device.type != "cuda":
        raise ValueError(f"slab_dequant_combine runs on CPU or CUDA tensors, got {q_slab.device}")
    return launch_slab_dequant_combine(A_blocks, scales, col_seg, q_slab)


def launch_slab_dequant_combine(A_blocks, scales, col_seg, q_slab) -> torch.Tensor:
    """The kernel launch of :func:`slab_dequant_combine` on CUDA tensors
    whose shapes and segment ids the wrapper has checked: dtypes and
    contiguity are checked here, the ids are not (so no device sync)."""
    dtypes = (A_blocks.dtype, scales.dtype, col_seg.dtype, q_slab.dtype)
    if dtypes != (torch.float32, torch.float32, torch.int32, torch.int8):
        raise TypeError(
            "the slab_dequant_combine kernel takes f32 A_blocks and scales, int32 col_seg and "
            f"int8 q, got {dtypes}"
        )
    if not all(t.is_contiguous() for t in (A_blocks, scales, col_seg, q_slab)):
        raise ValueError("the slab_dequant_combine kernel needs contiguous operands")
    K = q_slab.shape[0]
    if not 1 <= K <= MAX_AGENTS:
        raise ValueError(f"the slab_dequant_combine kernel takes 1..{MAX_AGENTS} agents, got K={K}")
    fn = _kernel("slab_dequant_combine_f32")
    out = torch.empty(q_slab.shape, dtype=torch.float32, device=q_slab.device)
    with torch.cuda.device(q_slab.device):
        stream = torch.cuda.current_stream(q_slab.device).cuda_stream
        err = fn(A_blocks.data_ptr(), scales.data_ptr(), col_seg.data_ptr(), q_slab.data_ptr(),
                 out.data_ptr(), K, scales.shape[1], A_blocks.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"slab_dequant_combine kernel launch failed: CUDA error {err}")
    bump(slab_dequant_combine)
    return out


slab_dequant_combine.launches = 0


def slab_source_combine_ref(w_blocks: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_source_combine`: the kernel's
    ordered loop over the sources, one rounded product and one rounded sum
    per source."""
    N, D = srcs.shape
    nb = w_blocks.shape[0]
    x = srcs.float().view(N, nb, LANES)
    w = w_blocks.float()
    out = torch.zeros(nb, LANES, dtype=torch.float32, device=srcs.device)
    for n in range(N):
        out = out + w[:, n, None] * x[n]
    return out.view(D)


def slab_source_combine(w_blocks: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    """Per-layer weighted combine over N stacked source slabs in ONE kernel
    launch (CUDA tensors) or through :func:`slab_source_combine_ref` (CPU
    tensors).  Returns a new (D,) f32 tensor."""
    if srcs.dim() != 2 or w_blocks.dim() != 2:
        raise ValueError(
            f"slab_source_combine needs w_blocks (nb, N) and srcs (N, D), got "
            f"{tuple(w_blocks.shape)} and {tuple(srcs.shape)}"
        )
    N, D = srcs.shape
    nb = w_blocks.shape[0]
    if nb * LANES != D:
        raise ValueError(f"slab width {D} != {nb} blocks x {LANES} lanes")
    if w_blocks.shape[1] != N:
        raise ValueError(f"w_blocks must be ({nb}, {N}), got {tuple(w_blocks.shape)}")
    if w_blocks.device != srcs.device:
        raise ValueError(f"w_blocks on {w_blocks.device}, srcs on {srcs.device}")
    if srcs.device.type == "cpu":
        return slab_source_combine_ref(w_blocks, srcs)
    if srcs.device.type != "cuda":
        raise ValueError(f"slab_source_combine runs on CPU or CUDA tensors, got {srcs.device}")
    if srcs.dtype != torch.float32 or w_blocks.dtype != torch.float32:
        raise TypeError(
            f"the slab_source_combine kernel takes float32 operands, got w_blocks "
            f"{w_blocks.dtype} and srcs {srcs.dtype}"
        )
    if not (srcs.is_contiguous() and w_blocks.is_contiguous()):
        raise ValueError("the slab_source_combine kernel needs contiguous operands")
    if not 1 <= N <= MAX_SOURCES:
        raise ValueError(f"the slab_source_combine kernel takes 1..{MAX_SOURCES} sources, got N={N}")
    fn = _kernel("slab_source_combine_f32")
    out = torch.empty(D, dtype=torch.float32, device=srcs.device)
    with torch.cuda.device(srcs.device):
        stream = torch.cuda.current_stream(srcs.device).cuda_stream
        err = fn(w_blocks.data_ptr(), srcs.data_ptr(), out.data_ptr(), N, nb, stream)
    if err != 0:
        raise RuntimeError(f"slab_source_combine kernel launch failed: CUDA error {err}")
    bump(slab_source_combine)
    return out


slab_source_combine.launches = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # pointers, ints, then the stream
    "slab_combine_f32": [_P, _P, _P, _I, _I, _P],
    "slab_source_combine_f32": [_P, _P, _P, _I, _I, _P],
    "slab_dequant_combine_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _kernel(name: str = "slab_combine_f32"):
    """One C entry point of the slab_combine library, its signature set."""
    from repro_torch.kernels import build

    fn = getattr(build.load("slab_combine"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn
