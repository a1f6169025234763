"""Parameter trees and the DRT layer partition.

A parameter tree is a nested ``dict`` of tensors.  The helpers here walk it
in SORTED key order, which is the order ``jax.tree`` flattens a dict in; the
port's leaf order therefore matches the reference's leaf for leaf.

The DRT penalty (paper eq. 10) is a product over *layers* p = 1..L.  A
model's parameters are a dict whose top-level keys are either

  * plain groups   -- e.g. ``stem``, ``head``: one DRT layer;
  * stacked groups -- keys ending in ``blocks``: every leaf carries a leading
    ``n_slots`` axis and each slot is one DRT layer.

(The reference's ``stacked_keys`` argument, which no caller sets, is not
ported.)

``LayerPartition`` assigns a contiguous layer index range to each top-level
key.

Conv weights sit in torch's OIHW order here and in HWIO order in the
reference.  A leaf is a conv weight when its key is ``proj`` or starts with
``conv`` (the ResNet-20 naming): :func:`conv_to_port_order` and
:func:`conv_to_reference_order` move such a leaf's axes, keeping every
leading (agent, slot) axis, and :func:`reference_index` gives each port
element its row-major index in the reference's layout (the coded exchange
hashes that index and samples its top-k threshold in that order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

Tree = Any


def tree_items(tree: Tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in sorted-key (``jax.tree``) order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure; dicts come back
    with sorted keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def container_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts (sorted keys), tuples and
    lists: trees with the optimizers' tuple states (``chain``) and ``()``
    for an empty state."""
    if isinstance(tree, dict):
        return {k: container_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(container_map(fn, x) for x in tree)
    return fn(tree)


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, itself where it is f32 already: no call into torch,
    which each of many threads sharing one process pays for (the permute
    engine's ranks)."""
    return x if x.dtype == torch.float32 else x.float()


def tree_like(tree: Tree, leaves) -> Tree:
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map_with_path(fn: Callable, tree: Tree, prefix: tuple = ()) -> Tree:
    """``fn(path, leaf)`` over one tree (path = tuple of dict keys)."""
    if isinstance(tree, dict):
        return {
            k: tree_map_with_path(fn, tree[k], prefix + (k,)) for k in sorted(tree)
        }
    return fn(prefix, tree)


def is_conv_weight(path: tuple) -> bool:
    name = path[-1] if path else ""
    return name == "proj" or name.startswith("conv")


def conv_to_port_order(path: tuple, x: np.ndarray) -> np.ndarray:
    """A reference-layout leaf -> the port's layout (a view):
    (..., H, W, I, O) -> (..., O, I, H, W) for a conv weight."""
    if is_conv_weight(path):
        return np.moveaxis(x, (-1, -2), (-4, -3))
    return x


def conv_to_reference_order(path: tuple, x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`conv_to_port_order` (a view)."""
    if is_conv_weight(path):
        return np.moveaxis(x, (-4, -3), (-1, -2))
    return x


def reference_index(path: tuple, shape: tuple) -> np.ndarray:
    """For a port leaf of ``shape`` at ``path`` (a single agent, slot axis
    included): the reference's row-major index of each element, as an
    int64 array of ``shape`` in the port's order."""
    ref_shape = shape
    if is_conv_weight(path):
        ref_shape = (*shape[:-4], shape[-2], shape[-1], shape[-3], shape[-4])
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.int64).reshape(ref_shape)
    return np.ascontiguousarray(conv_to_port_order(path, idx))


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    key: str
    stacked: bool
    n_slots: int
    offset: int  # starting DRT layer index


@dataclasses.dataclass(frozen=True)
class LayerPartition:
    """Maps top-level parameter groups to DRT layer indices.

    Counterpart of ``repro.utils.pytree.LayerPartition``.  The reference
    trainer builds its partition from a template made by ``jax.tree.map``,
    which rebuilds dicts with sorted keys; the port sorts explicitly, so a
    ResNet-20 gets ``head`` = 0, ``stage1_blocks`` = 1-3, ``stage2_blocks`` =
    4-6, ``stage3_blocks`` = 7-9 and ``stem`` = 10 on both sides.
    """

    groups: tuple[GroupSpec, ...]
    num_layers: int

    @staticmethod
    def build(params: Tree) -> "LayerPartition":
        """Build a partition from a single-agent parameter template (tensors
        or anything with a ``shape``).  Top-level keys ending in ``blocks``
        are stacked: their leaves carry a leading slot axis."""
        if not isinstance(params, dict):
            raise TypeError("params template must be a top-level dict")
        groups = []
        offset = 0
        for key in sorted(params):
            leaves = tree_leaves(params[key])
            if not leaves:
                continue
            if key.endswith("blocks"):
                n = int(leaves[0].shape[0])
                for leaf in leaves:
                    if int(leaf.shape[0]) != n:
                        raise ValueError(
                            f"stacked group {key!r}: inconsistent leading axis "
                            f"{leaf.shape[0]} != {n}"
                        )
                groups.append(GroupSpec(key, True, n, offset))
            else:
                n = 1
                groups.append(GroupSpec(key, False, 1, offset))
            offset += n
        return LayerPartition(groups=tuple(groups), num_layers=offset)

    # -- per-layer reductions and combine (the tree oracle's algebra) ---------

    def sq_norms(self, tree: Tree) -> torch.Tensor:
        """Per-DRT-layer squared norms of a single-agent tree: ``(L,)`` f32."""
        out = []
        for g in self.groups:
            leaves = [as_f32(leaf) for leaf in tree_leaves(tree[g.key])]
            acc = None
            for sq in torch._foreach_mul(leaves, leaves):  # the squares in one multi-tensor op
                s = _sum_from(sq, 1) if g.stacked else sq.sum()[None]
                acc = s if acc is None else acc + s
            out.append(acc)
        return torch.cat(out)

    def agent_sq_norms(self, tree_K: Tree) -> torch.Tensor:
        """Per-agent, per-layer squared norms of an agent-stacked tree:
        ``(L, K)`` f32."""
        out = []
        for g in self.groups:
            acc = None
            for leaf in tree_leaves(tree_K[g.key]):
                sq = leaf.float().square()
                s = _sum_from(sq, 2).T if g.stacked else _sum_from(sq, 1)[None]  # (n, K) / (1, K)
                acc = s if acc is None else acc + s
            out.append(acc)
        return torch.cat(out, dim=0)

    def gram(self, tree_K: Tree) -> torch.Tensor:
        """Per-layer agent Gram matrices ``(L, K, K)`` f32, leaf by leaf,
        accumulated in f32."""
        grams = []
        for g in self.groups:
            acc = None
            for leaf in tree_leaves(tree_K[g.key]):
                K = leaf.shape[0]
                if g.stacked:
                    flat = leaf.float().reshape(K, leaf.shape[1], -1).transpose(0, 1)  # (n, K, d)
                    gm = torch.bmm(flat, flat.transpose(1, 2))
                else:
                    flat = leaf.float().reshape(K, -1)
                    gm = (flat @ flat.T)[None]
                acc = gm if acc is None else acc + gm
            grams.append(acc)
        return torch.cat(grams, dim=0)

    def pairwise_sq_dists(self, tree_K: Tree) -> tuple[torch.Tensor, torch.Tensor]:
        """All-pairs per-layer squared distances by the Gram trick:
        ``d2[p, l, k] = n2[p, l] + n2[p, k] - 2 <w_l, w_k>`` (clamped at 0)
        and ``n2[p, l] = ||w_l^(p)||^2``.  Returns ``(d2 (L, K, K), n2 (L,
        K))``."""
        gram = self.gram(tree_K)
        n2 = torch.diagonal(gram, dim1=1, dim2=2)
        d2 = n2[:, :, None] + n2[:, None, :] - 2.0 * gram
        return torch.clamp(d2, min=0.0), n2

    def combine(self, A: torch.Tensor, tree_K: Tree) -> Tree:
        """Per-layer mixing ``new_k^(p) = sum_l A[p, l, k] psi_l^(p)`` of an
        agent-stacked tree (``A`` (L, K, K), column-stochastic over axis 1),
        accumulated in f32, each leaf back in its dtype."""
        new = dict(tree_K)
        A = A.float()
        for g in self.groups:
            if g.stacked:
                A_g = A[g.offset : g.offset + g.n_slots]  # (n, K, K)

                def comb(x, A_g=A_g):
                    out = torch.einsum("jlk,lj...->kj...", A_g, x.float())
                    return out.to(x.dtype)
            else:
                A_g = A[g.offset]  # (K, K)

                def comb(x, A_g=A_g):
                    return torch.einsum("lk,l...->k...", A_g, x.float()).to(x.dtype)

            new[g.key] = tree_map(comb, tree_K[g.key])
        return {k: new[k] for k in sorted(new)}

    def scale_by_layer(self, weights: torch.Tensor, tree: Tree) -> Tree:
        """Multiply each DRT layer of a single-agent tree by its weight
        (``weights`` (L,)), in f32, each leaf back in its dtype."""
        new = dict(tree)
        w_all = as_f32(weights)

        def back(y, like):  # no call into torch where the dtype is the leaf's already
            return y if y.dtype == like.dtype else y.to(like.dtype)

        for g in self.groups:
            if g.stacked:
                w, shaped = w_all[g.offset : g.offset + g.n_slots], {}

                def scale(x, w=w, shaped=shaped):
                    if x.dim() not in shaped:  # the slot weights shaped once per number of axes
                        shaped[x.dim()] = w.reshape(-1, *([1] * (x.dim() - 1)))
                    return back(as_f32(x) * shaped[x.dim()], x)
            else:
                w = w_all[g.offset]

                def scale(x, w=w):
                    return back(as_f32(x) * w, x)

            new[g.key] = tree_map(scale, tree[g.key])
        return {k: new[k] for k in sorted(new)}


def _sum_from(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over axes ``dim..`` (none when ``x`` has no more: torch's
    ``sum(dim=())`` would reduce every axis)."""
    return x.sum(dim=tuple(range(dim, x.dim()))) if x.dim() > dim else x


def agent_template(params_K: Tree) -> Tree:
    """Single-agent shape template (``torch.empty`` on the meta device) from
    an agent-stacked tree."""
    return tree_map(
        lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"), params_K
    )
