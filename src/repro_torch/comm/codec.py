"""Wire codecs: what crosses the agent boundary in a coded consensus round.

Counterpart of ``repro.comm.codec`` for what the slab path reads from a
codec: its kind and parameters, its analytic wire bytes, its per-agent
state, and the shared top-k threshold rule.  The registry resolves names
(``identity``, ``bf16``, ``f16``, ``int8``, ``topk``, with ``name:arg``
suffixes such as ``topk:0.05``) exactly as the reference does.

The slab engine encodes on the packed slab (``repro_torch.core.packing``
``slab_encode_batched`` and the ``slab_codec`` kernels).  The reference's
per-leaf tree ``encode``/``decode`` belong to its tree path, which is not
ported yet.

Only floating-point leaves are compressed (the slab path packs nothing
else); wire bytes count integer leaves verbatim, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import numpy as np
import torch

from repro_torch.utils.pytree import Tree, tree_items, tree_map


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape), dtype=np.int64))


def _leaf_bytes(leaf) -> int:
    return _numel(leaf) * leaf.dtype.itemsize


def _stacked_flags(tree: Tree) -> list[bool]:
    """Per leaf (sorted-key order): does it live in a stacked group (a
    top-level key ending in ``blocks``)?"""
    if isinstance(tree, dict):
        flags: list[bool] = []
        for k in sorted(tree):
            flags += [k.endswith("blocks")] * len(list(tree_items(tree[k])))
        return flags
    return [False] * len(list(tree_items(tree)))


@dataclasses.dataclass(frozen=True)
class IdentityCodec:
    """Full-precision exchange: the exact consensus path."""

    name: str = "identity"
    stateful: bool = False
    needs_rng: bool = False

    def wire_bytes(self, template: Tree) -> int:
        return sum(_leaf_bytes(l) for _, l in tree_items(template))


@dataclasses.dataclass(frozen=True)
class CastCodec:
    """Reduced-precision cast (bf16 / f16): the receiver sees the f32
    round-trip of the cast, with round-to-nearest-even."""

    dtype: torch.dtype = torch.bfloat16
    name: str = "bf16"
    stateful: bool = False
    needs_rng: bool = False

    def wire_bytes(self, template: Tree) -> int:
        item = self.dtype.itemsize
        return sum(
            _numel(l) * item if l.dtype.is_floating_point else _leaf_bytes(l)
            for _, l in tree_items(template)
        )


@dataclasses.dataclass(frozen=True)
class Int8StochasticCodec:
    """Per-layer-scaled int8 with stochastic rounding:
    ``q = clip(floor(x / s + u), -qmax, qmax)``, ``s = absmax / qmax`` per
    (leaf, scan slot) in stacked groups and per leaf otherwise, ``u`` from
    the counter hash (:mod:`repro_torch.comm.rng`).  Unbiased; 4x smaller
    than f32 plus one f32 scale per segment."""

    name: str = "int8"
    stateful: bool = False
    needs_rng: bool = True
    qmax: float = 127.0

    def wire_bytes(self, template: Tree) -> int:
        total = 0
        for (_, l), stacked in zip(tree_items(template), _stacked_flags(template)):
            if l.dtype.is_floating_point:
                n_scales = int(l.shape[0]) if stacked and len(l.shape) >= 2 else 1
                total += _numel(l) + 4 * n_scales
            else:
                total += _leaf_bytes(l)
        return total


def _topk_count(n: int, frac: float) -> int:
    return max(1, int(math.ceil(frac * n)))


def topk_sample_plan(n: int, frac: float, sample: int) -> tuple[int, int]:
    """Static per-leaf threshold plan ``(stride, k_sub)`` (the reference's
    ``_topk_sample_plan``): ``stride == 1`` takes the ``k_sub``-th largest
    |y| of the whole leaf; ``stride > 1`` the ``k_sub``-th largest of the
    strided subsample ``|y|[::stride]`` in the reference's element order."""
    if sample <= 0 or n <= sample:
        return 1, _topk_count(n, frac)
    stride = -(-n // sample)
    m = -(-n // stride)  # len(range(0, n, stride))
    return stride, max(1, min(m, int(math.ceil(frac * m))))


def topk_threshold(sub: torch.Tensor, k: int) -> torch.Tensor:
    """The threshold of the shared rule: the ``k``-th largest entry along
    the last axis of the sampled magnitudes ``sub``."""
    return torch.topk(sub, k, dim=-1, sorted=True).values[..., -1]


@dataclasses.dataclass(frozen=True)
class TopKCodec:
    """Magnitude top-k per leaf with a per-agent error-feedback residual:
    each round offers ``y = x + residual``, sends the entries with
    ``|y| >= threshold`` (and ``|y| > 0``) and keeps the rest as the next
    residual.  Wire bytes count ``k`` (f32 value, i32 index) pairs per
    leaf."""

    frac: float = 0.1
    name: str = "topk"
    stateful: bool = True
    needs_rng: bool = False
    sample: int = 1024

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {self.frac}")
        if self.sample < 0:
            raise ValueError(f"topk sample must be >= 0, got {self.sample}")

    def wire_bytes(self, template: Tree) -> int:
        return sum(
            8 * _topk_count(_numel(l), self.frac) if l.dtype.is_floating_point else _leaf_bytes(l)
            for _, l in tree_items(template)
        )


WireCodec = Union[IdentityCodec, CastCodec, Int8StochasticCodec, TopKCodec]


def init_comm_state(codec: "str | WireCodec | None", params_K: Tree) -> Tree:
    """Per-agent codec state stacked over the leading agent axis: an f32
    zero residual tree for top-k, ``()`` for stateless codecs."""
    if make_codec(codec).stateful:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), params_K)
    return ()


_REGISTRY: dict[str, Callable[..., WireCodec]] = {
    "identity": lambda: IdentityCodec(),
    "bf16": lambda: CastCodec(dtype=torch.bfloat16, name="bf16"),
    "f16": lambda: CastCodec(dtype=torch.float16, name="f16"),
    "int8": lambda: Int8StochasticCodec(),
    "topk": lambda frac=0.1, sample=1024: TopKCodec(frac=float(frac), sample=int(sample)),
}


def codec_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_codec(spec: "str | WireCodec | None") -> WireCodec:
    """Resolve a codec: an instance -> itself; ``None`` -> identity; a name
    -> the registry, with ``:``-separated arguments (``topk:0.05``,
    ``topk:0.1:0`` for an exact-threshold top-k)."""
    if spec is None:
        return _REGISTRY["identity"]()
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    if name not in _REGISTRY:
        raise ValueError(f"unknown codec {name!r}; registered: {codec_names()}")
    try:
        return _REGISTRY[name](*arg.split(":")) if arg else _REGISTRY[name]()
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad codec spec {spec!r}: {e}") from e
