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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

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


def tree_map_with_path(fn: Callable, tree: Tree, prefix: tuple = ()) -> Tree:
    """``fn(path, leaf)`` over one tree (path = tuple of dict keys)."""
    if isinstance(tree, dict):
        return {
            k: tree_map_with_path(fn, tree[k], prefix + (k,)) for k in sorted(tree)
        }
    return fn(prefix, tree)


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


def agent_template(params_K: Tree) -> Tree:
    """Single-agent shape template (``torch.empty`` on the meta device) from
    an agent-stacked tree."""
    return tree_map(
        lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"), params_K
    )
