"""threefry2x32 keys: the reference's ``jax.random`` key derivation in numpy.

The reference derives every stochastic-rounding key with ``jax.random``:
``key(seed)``, ``fold_in(key, i)``, ``split(key, n)`` and ``key_data``.
Under ``jax_threefry_partitionable=True`` (JAX's default since 0.5):

* ``key_data(key(s)) == [0, s]`` for ``0 <= s < 2^32``;
* ``fold_in(k, i) == threefry2x32(k, (0, i))``;
* ``split(k, n)[i] == fold_in(k, i)``;
* ``bits(k, shape, uint32)`` at row-major index ``i`` is ``y0 ^ y1`` of
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``, so a draw is a function
  of the flat index and any subset of a shape can be drawn on its own.

A key here is a ``(2,)`` (or ``(..., 2)``) numpy ``uint32`` array of its two
words.  The tables the coded round needs (rounds x K x n_leaves words) are
tiny and known on the host, so they are computed here in numpy and copied
to the device once per round (:func:`words_to_tensor`).

The draws themselves (:func:`random_bits`, :func:`uniform`,
:func:`normal`, and their ``*_at`` forms over explicit flat indices) run on
the indices' device in torch: 32-bit words live in int64 tensors holding
``0 .. 2^32 - 1``, as in ``repro_torch.comm.rng``.  Bits and uniforms equal
``jax.random.bits`` / ``jax.random.uniform`` bit for bit; ``normal`` is
``sqrt(2) erfinv(u)`` with XLA's f32 ``erf_inv`` (Giles' polynomial, each
step one rounding as a fused multiply-add) and lies within
:data:`NORMAL_ULPS` f32 ulps of ``jax.random.normal`` (the ``log1p`` and
``sqrt`` of the two libraries differ in the last bits).
"""
from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher (20 rounds) of counter pairs
    ``(x0, x1)`` under ``key`` (two uint32 words, broadcast against the
    counters)."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 sums wrap mod 2^32, as intended
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``key_data(jax.random.key(seed))`` for a 32-bit seed."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be a 32-bit unsigned value, got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """``fold_in(k, data)`` for a scalar key and scalar or array ``data``:
    returns ``(*data.shape, 2)`` words."""
    d = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(np.asarray(k, np.uint32), np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def split(k: np.ndarray, n: int) -> np.ndarray:
    """``split(k, n)`` of a key ``(2,)`` or a batch of keys ``(..., 2)``:
    ``(..., n, 2)`` words, row ``i`` equal to ``fold_in(k, i)``."""
    i = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(np.asarray(k, np.uint32)[..., None, :], np.zeros_like(i), i)
    return np.stack([y0, y1], axis=-1)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 key words (numpy) -> an int32 tensor of the same bit patterns
    on ``device``, as the int8 kernels take them."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)


# -- draws on a device ---------------------------------------------------------------

_M32 = 0xFFFFFFFF
NORMAL_ULPS = 4  # normal_at vs jax.random.normal: at most 3 seen over 2e6 draws
# XLA's f32 erf_inv (Giles): coefficients for w < 5, then for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))  # uniform's minval for normal
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))  # (maxval - minval) in f32: 2.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _key_words(k):
    """A key as its two words: Python ints from a (2,) uint32 array, or
    int64 tensors from a (..., 2) int64 tensor of uint32 values (one key
    per element, broadcast against the counters)."""
    if torch.is_tensor(k):
        return k[..., 0], k[..., 1]
    return tuple(int(w) for w in np.asarray(k, np.uint32))


def keys_tensor(keys: np.ndarray, device=None) -> torch.Tensor:
    """uint32 key words ``(..., 2)`` as an int64 tensor on ``device``: keys
    that :func:`bits_at` and its kin take one per element."""
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64), device=device)


def threefry2x32_tensor(k, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors of uint32 counter words (on
    any device) under the key ``k``: two uint32 words, or an int64 tensor
    of keys (:func:`keys_tensor`) broadcast against the counters."""
    k0, k1 = _key_words(k)
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + (ks[(i + 2) % 3] + i + 1)) & _M32
    return a, b


def bits_at(k, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` at the flat indices ``idx``
    (int64, any shape and device): uint32 values in int64.  ``k``: one key
    (two uint32 words) or a tensor of keys, one per element
    (:func:`threefry2x32_tensor`)."""
    y0, y1 = threefry2x32_tensor(k, idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform_at(k, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` at the flat indices
    ``idx``: the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    one = (bits_at(k, idx) >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``; each polynomial step ``c + p w`` rounded once
    (in f64, exact for an f32 product), as XLA contracts it."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, float(np.float32(lo)), float(np.float32(hi)))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal_at(k, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` at the flat indices ``idx``,
    within :data:`NORMAL_ULPS` ulps: ``sqrt(2) erfinv(u)`` with ``u``
    uniform on ``(-1, 1)``."""
    u = torch.clamp(uniform_at(k, idx) * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2 * _erfinv_f32(u)


def _flat(shape, device) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def random_bits(k, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` on ``device`` (uint32 in int64)."""
    return bits_at(k, _flat(shape, device))


def uniform(k, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` on ``device``, bit for bit."""
    return uniform_at(k, _flat(shape, device))


def normal(k, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on ``device``, within
    :data:`NORMAL_ULPS` ulps."""
    return normal_at(k, _flat(shape, device))
