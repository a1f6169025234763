"""Wire codecs: what crosses the agent boundary in a coded consensus round.

Counterpart of ``repro.comm.codec`` for what the slab path reads from a
codec: its kind and parameters, its analytic wire bytes, its per-agent
state, and the shared top-k threshold rule.  The registry resolves names
(``identity``, ``bf16``, ``f16``, ``int8``, ``topk``, with ``name:arg``
suffixes such as ``topk:0.05``) exactly as the reference does.

The slab engine encodes on the packed slab (``repro_torch.core.consensus``
``slab_encode_batched`` and the ``slab_codec`` kernels).  The per-leaf
contract, which the tree oracle (``gather_consensus_step``) runs once per
agent, is the reference's, on single-agent trees:

  ``init_state(template)``      -> per-agent state (``()`` if stateless)
  ``encode(tree, state, key)``  -> ``(wire, new_state)``
  ``decode(wire)``              -> the f32 reconstruction of the tree

``key`` is two uint32 key words (:mod:`repro_torch.comm.prng`).  The int8
wire (:class:`QuantLeaf` per leaf) and the top-k wire and residual equal
the reference's bit for bit: int8 splits the key over the tree's leaves
with ``prng.split`` and hashes each element's REFERENCE-layout index
(:mod:`repro_torch.comm.rng`; conv weights sit in OIHW order here), and
top-k samples its threshold's elements in the reference's order.  A
decoded wire may carry a leading agent axis (the scales broadcast).

Only floating-point leaves are compressed (the slab path packs nothing
else); wire bytes count integer leaves verbatim, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.rng import uniform_from_words
from repro_torch.utils.pytree import Tree, reference_index, tree_items, tree_map, tree_map_with_path

F32 = torch.float32


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


class QuantLeaf(NamedTuple):
    """Wire form of one int8-quantized leaf: values and scales."""

    q: torch.Tensor  # int8, the leaf's shape
    s: torch.Tensor  # f32 scales, broadcastable to q (kept dims)


def _is_float(x) -> bool:
    return x.dtype.is_floating_point


def _quant_scale_dims(x: torch.Tensor, stacked: bool) -> tuple[int, ...]:
    """Scale granularity: one scale per slot of a stacked-group leaf (its
    leading axis is the slot), one per tensor otherwise."""
    if stacked and x.dim() >= 2:
        return tuple(range(1, x.dim()))
    return tuple(range(x.dim()))


@functools.lru_cache(maxsize=None)
def _reference_positions(path: tuple, shape: tuple) -> np.ndarray:
    """Port flat positions of a leaf's elements in the reference's
    row-major order: ``flat_port[pos]`` is ``flat_reference``."""
    pos = np.empty(int(np.prod(shape, dtype=np.int64)), np.int64)
    pos[reference_index(path, shape).ravel()] = np.arange(pos.size)
    return pos


@dataclasses.dataclass(frozen=True)
class IdentityCodec:
    """Full-precision exchange: the exact consensus path."""

    name: str = "identity"
    stateful: bool = False
    needs_rng: bool = False

    def init_state(self, template):
        return ()

    def encode(self, tree, state=(), key=None):
        return tree, state

    def decode(self, wire):
        return wire

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

    def init_state(self, template):
        return ()

    def encode(self, tree, state=(), key=None):
        return tree_map(lambda x: x.to(self.dtype) if _is_float(x) else x, tree), state

    def decode(self, wire):
        return tree_map(lambda x: x.float() if _is_float(x) else x, wire)

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

    def init_state(self, template):
        return ()

    def encode(self, tree, state=(), key=None):
        """Per leaf ``i`` (sorted-key order): key words ``split(key,
        n_leaves)[i]``, scales ``absmax * f32(1 / qmax)`` over the leaf (or
        each slot of a stacked-group leaf), the counter-hash uniforms of the
        elements' reference indices, ``q = clip(floor(x / s + u))``."""
        if key is None:
            raise ValueError("int8 codec needs an rng key (stochastic rounding)")
        items = list(tree_items(tree))
        words = prng.split(np.asarray(key, np.uint32), len(items))
        inv = float(np.float32(1.0) / np.float32(self.qmax))
        wire = {}
        for (path, leaf), (w0, w1), stacked in zip(items, words, _stacked_flags(tree)):
            if not _is_float(leaf):
                wire[path] = leaf
                continue
            x = leaf.float()
            absmax = x.abs().amax(dim=_quant_scale_dims(x, stacked), keepdim=True)
            s = torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))
            idx = torch.from_numpy(reference_index(path, tuple(x.shape))).to(x.device)
            u = uniform_from_words(torch.tensor(int(w0)), torch.tensor(int(w1)), idx)
            q = torch.clamp(torch.floor(x / s + u), -self.qmax, self.qmax)
            wire[path] = QuantLeaf(q=q.to(torch.int8), s=s)
        return tree_map_with_path(lambda path, _: wire[path], tree), state

    def decode(self, wire):
        return tree_map(lambda x: x.q.float() * x.s if isinstance(x, QuantLeaf) else x, wire)

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

    def init_state(self, template):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=F32 if _is_float(x) else x.dtype,
                                              device=x.device), template)

    def encode(self, tree, state, key=None):
        """Per float leaf: ``y = x + residual``, the threshold of the shared
        rule on ``|y|`` (sampled in the reference's element order), the
        entries with ``|y| >= threshold`` and ``|y| > 0`` sent, the rest the
        new residual."""
        if state is None or state == ():
            state = self.init_state(tree)
        sent, res = {}, {}
        for (path, x), (_, r) in zip(tree_items(tree), tree_items(state)):
            if not _is_float(x):
                sent[path], res[path] = x, r
                continue
            y = x.float() + r
            ay = y.abs()
            stride, k = topk_sample_plan(y.numel(), self.frac, self.sample)
            flat = ay.reshape(-1)
            if stride > 1:
                pos = _reference_positions(path, tuple(y.shape))[::stride]
                flat = flat[torch.from_numpy(pos).to(flat.device)]
            thresh = topk_threshold(flat, k)
            sent[path] = torch.where((ay >= thresh) & (ay > 0.0), y, 0.0)
            res[path] = y - sent[path]
        return (tree_map_with_path(lambda p, _: sent[p], tree),
                tree_map_with_path(lambda p, _: res[p], tree))

    def decode(self, wire):
        return wire

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
