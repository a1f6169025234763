"""Carry parameter trees between the JAX reference and the port.

The two frameworks draw different random numbers from the same seed, so
parity runs start both sides from the SAME weights, moved across as numpy
arrays.  Conv weights change layout at this boundary: HWIO on the JAX side,
OIHW on the torch side; every leading axis (agent, scan slot) is kept.
Other leaves pass through unchanged.  The same functions carry optimizer
moments (trees shaped like the parameters, e.g. ``{"m": ..., "v": ...}``).

LM parameter trees (``lm_params_from_jax``) keep every leaf's layout.

The conv rule (which leaves, which axes) lives in
``repro_torch.utils.pytree``, beside the index map the coded exchange
builds from it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import conv_to_port_order, conv_to_reference_order, tree_map, tree_map_with_path

Tree = Any


def params_from_jax(np_tree: Tree, device: "torch.device | str | None" = None) -> Tree:
    """A reference (HWIO) tree of arrays -> a torch (OIHW) tree on ``device``
    (CUDA unless given).  Leaves are copied."""
    dev = resolve_device(device)

    def leaf(path, x):
        x = conv_to_port_order(path, np.asarray(x))
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    return tree_map_with_path(leaf, np_tree)


def params_to_jax(tree: Tree) -> Tree:
    """A torch (OIHW) tree -> a tree of numpy arrays in the reference's
    (HWIO) layout."""

    def leaf(path, x):
        return np.ascontiguousarray(conv_to_reference_order(path, x.detach().cpu().numpy()))

    return tree_map_with_path(leaf, tree)


def lm_params_from_jax(np_tree: Tree, device: "torch.device | str | None" = None) -> Tree:
    """A reference LM parameter tree (``repro.models.transformer``) of arrays
    -> the port's tree of tensors on ``device`` (CUDA unless given).  Names
    and layouts are kept as they are (``wq`` (d, H, hd), ``wo`` (H, hd, d),
    ``conv_w`` (d_conv, di), ``A_log`` (di, ds)), the group's repeat axis
    first: no leaf of an LM changes layout.  Leaves are copied."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.ascontiguousarray(x), device=dev), np_tree)


def lm_params_to_jax(tree: Tree) -> Tree:
    """Inverse of :func:`lm_params_from_jax`: a tree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
