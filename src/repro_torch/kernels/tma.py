"""Tensor-map arguments for the kernels that load tiles with the Tensor
Memory Accelerator (TMA): ``slab_combine`` and the bf16 ``flash_attention``.

A TMA load copies one box of a tensor from device memory into shared
memory; the kernel's C entry point encodes the map (``csrc/tma.cuh``,
``cuTensorMapEncodeTiled``) from the arguments built here.  TMA refuses

* a base address that is not 16-byte aligned,
* a byte stride (of any dimension but the innermost, which must have unit
  stride) that is not a multiple of 16, or of 2^40 bytes or more,
* a dimension of more than 2^32 elements,
* a box extent outside 1..256, or an innermost box row that is not a
  multiple of 16 bytes,

so :func:`tensor_map_args` raises ``ValueError`` on each of them.  It never
copies a tensor to make it fit: a caller hands the kernels views whose base
and strides meet these rules (a contiguous tensor, or a view of one at a
16-byte offset, such as the LM's (B, S, H, hd) projections seen as (B, H,
S, hd)).  A dimension of extent 1 is never stepped over, so its stride is
not checked (and is passed as 16).

:func:`pack` lays the arguments out as the 16 int64 words the C side reads:
``[rank, dims[0..4], byte strides[0..3], box[0..4]]``, innermost first.
Nothing here needs a GPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

ALIGN = 16  # bytes: base address and every byte stride
MAX_DIM = 2**32
MAX_STRIDE = 2**40
MAX_BOX = 256
PACKED_WORDS = 16


class TensorMapArgs(NamedTuple):
    """One tensor map: base address, dims and box (innermost first) and the
    byte strides of dims 1.. (dim 0 has unit stride)."""

    base: int
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]


def tensor_map_args(t: torch.Tensor, axes: Sequence[int], box: Sequence[int], *, name: str = "tensor") -> TensorMapArgs:
    """The map over ``t`` whose dimension ``i`` is ``t``'s axis ``axes[i]``
    (``axes[0]`` the innermost, of unit stride), loaded in boxes of
    ``box[i]`` elements along it.  Raises ``ValueError`` on what TMA
    refuses (module docstring)."""
    if len(axes) != len(box) or not 1 <= len(axes) <= 5:
        raise ValueError(f"{name}: a tensor map takes 1..5 axes and one box extent each, got {axes} and {box}")
    if sorted(axes) != list(range(t.dim())):
        raise ValueError(f"{name}: axes {tuple(axes)} must name each of the tensor's {t.dim()} axes once")
    esize = t.element_size()
    base = t.data_ptr()
    if base % ALIGN:
        raise ValueError(f"{name}: TMA needs a {ALIGN}-byte aligned base address, got one at {base % ALIGN} "
                         f"bytes past a boundary (storage offset {t.storage_offset()})")
    dims = tuple(int(t.shape[a]) for a in axes)
    if any(d < 1 or d > MAX_DIM for d in dims):
        raise ValueError(f"{name}: TMA takes dimensions of 1..2^32 elements, got {dims}")
    if t.stride(axes[0]) != 1 and dims[0] > 1:
        raise ValueError(f"{name}: TMA needs unit stride along the innermost axis, got stride {t.stride(axes[0])}")
    strides = []
    for a, d in zip(axes[1:], dims[1:]):
        s = t.stride(a) * esize
        if d == 1:
            s = ALIGN
        elif s % ALIGN or not 0 < s < MAX_STRIDE:
            raise ValueError(f"{name}: TMA needs byte strides that are positive multiples of {ALIGN} below 2^40, "
                             f"got {s} along axis {a}")
        strides.append(s)
    box = tuple(int(b) for b in box)
    if any(not 1 <= b <= MAX_BOX for b in box):
        raise ValueError(f"{name}: TMA boxes take 1..{MAX_BOX} elements per dimension, got {box}")
    if box[0] * esize % ALIGN:
        raise ValueError(f"{name}: a TMA box row must be a multiple of {ALIGN} bytes, got {box[0] * esize}")
    return TensorMapArgs(base, dims, tuple(strides), box)


def pack(args: TensorMapArgs):
    """The 16 int64 words of ``csrc/tma.cuh``: rank, dims, byte strides,
    box, innermost first, unused words 0."""
    rank = len(args.dims)
    words = [0] * PACKED_WORDS
    words[0] = rank
    words[1 : 1 + rank] = args.dims
    words[6 : 6 + rank - 1] = args.strides
    words[10 : 10 + rank] = args.box
    return (ctypes.c_int64 * PACKED_WORDS)(*words)
