"""Counter-based uniforms for stochastic rounding.

Counterpart of ``repro.comm.rng``, bit for bit: a leaf's uniforms are
``uniform_from_words(w0, w1, idx)`` with ``(w0, w1)`` the two key words of
the leaf's threefry key (:mod:`repro_torch.comm.prng`) and ``idx`` the
element's row-major index in the REFERENCE layout of the leaf
(``SlabLayout.col_idx`` carries it per slab column).  The hash is a
murmur3-style double avalanche:

    x = idx * 0x9E3779B9 + w0;  x = fmix32(x) ^ w1;  bits = fmix32(x)
    u = (bits >> 8) * 2^-24                       (exact f32 in [0, 1))

torch has no full uint32 arithmetic on the CPU, so 32-bit words live in
int64 tensors holding ``0 .. 2^32 - 1`` and every product is reduced mod
2^32.  An int64 product of two 32-bit values can pass 2^63, so
:func:`mul32` splits the multiplier into 16-bit halves: each partial
product stays below 2^48.  The CUDA kernels compute the same hash in
``uint32_t`` (``kernels/csrc/wire_view.cuh``).
"""
from __future__ import annotations

import torch

PHI = 0x9E3779B9  # 2^32 / golden ratio: index stride constant
C1 = 0x85EBCA6B  # murmur3 fmix32 multipliers
C2 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF
INV24 = 2.0**-24


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits as an unsigned
    value (an int32 tensor of bit patterns reads back as its uint32)."""
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in ``[0, 2^32)`` (int64) and a 32-bit
    constant ``c``, without passing 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64-held uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, C1)
    x = x ^ (x >> 13)
    x = mul32(x, C2)
    return x ^ (x >> 16)


def counter_bits(w0: torch.Tensor, w1: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hash (in int64) of (key words, element counter); broadcasts."""
    x = (mul32(as_u32(idx), PHI) + as_u32(w0)) & MASK32
    x = fmix32(x) ^ as_u32(w1)
    return fmix32(x)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 U[0, 1): the top 24 bits times 2^-24 (exact; 1.0 is
    never produced)."""
    return (bits >> 8).to(torch.float32) * INV24


def uniform_from_words(w0, w1, idx) -> torch.Tensor:
    """The shared per-element rule: f32 U[0,1) from key words + index."""
    return bits_to_uniform(counter_bits(w0, w1, idx))


def counter_uniform(words, shape) -> torch.Tensor:
    """U[0, 1) f32 draws of ``shape`` from one key's ``(w0, w1)`` words:
    element ``i`` (row-major) gets ``uniform_from_words(w0, w1, i)``."""
    w0, w1 = (torch.as_tensor(int(w), dtype=torch.int64) for w in words)
    n = 1
    for d in shape:
        n *= int(d)
    return uniform_from_words(w0, w1, torch.arange(n, dtype=torch.int64)).reshape(shape)
