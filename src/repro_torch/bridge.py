"""Carry parameter trees between the JAX reference and the port.

The two frameworks draw different random numbers from the same seed, so
parity runs start both sides from the SAME weights, moved across as numpy
arrays.  Conv weights change layout at this boundary: HWIO on the JAX side,
OIHW on the torch side; every leading axis (agent, scan slot) is kept.
Other leaves pass through unchanged.  The same functions carry optimizer
moments (trees shaped like the parameters, e.g. ``{"m": ..., "v": ...}``).

A leaf is a conv weight when its key is ``proj`` or starts with ``conv``
(the ResNet-20 naming).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_map_with_path

Tree = Any


def _is_conv(path: tuple) -> bool:
    name = path[-1] if path else ""
    return name == "proj" or name.startswith("conv")


def params_from_jax(np_tree: Tree, device: "torch.device | str | None" = None) -> Tree:
    """A reference (HWIO) tree of arrays -> a torch (OIHW) tree on ``device``
    (CUDA unless given).  Leaves are copied."""
    dev = resolve_device(device)

    def leaf(path, x):
        x = np.asarray(x)
        if _is_conv(path):
            x = np.moveaxis(x, (-1, -2), (-4, -3))  # (..., H, W, I, O) -> (..., O, I, H, W)
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    return tree_map_with_path(leaf, np_tree)


def params_to_jax(tree: Tree) -> Tree:
    """A torch (OIHW) tree -> a tree of numpy arrays in the reference's
    (HWIO) layout."""

    def leaf(path, x):
        a = x.detach().cpu().numpy()
        if _is_conv(path):
            a = np.moveaxis(a, (-4, -3), (-1, -2))  # (..., O, I, H, W) -> (..., H, W, I, O)
        return np.ascontiguousarray(a)

    return tree_map_with_path(leaf, tree)
