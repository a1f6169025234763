"""threefry2x32 keys: the reference's ``jax.random`` key derivation in numpy.

The reference derives every stochastic-rounding key with ``jax.random``:
``key(seed)``, ``fold_in(key, i)``, ``split(key, n)`` and ``key_data``.
Under ``jax_threefry_partitionable=True`` (JAX's default since 0.5):

* ``key_data(key(s)) == [0, s]`` for ``0 <= s < 2^32``;
* ``fold_in(k, i) == threefry2x32(k, (0, i))``;
* ``split(k, n)[i] == fold_in(k, i)``.

A key here is a ``(2,)`` (or ``(..., 2)``) numpy ``uint32`` array of its two
words.  The tables the coded round needs (rounds x K x n_leaves words) are
tiny and known on the host, so they are computed here in numpy and copied
to the device once per round (:func:`words_to_tensor`).
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
