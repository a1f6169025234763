"""Checkpoints of the port's training state: flat-keyed ``.npz`` files.

The file format is the reference's (``repro.ckpt``), so either package
reads what the other writes:

* one ``step_%08d.npz`` a step, written to ``.tmp_step_%08d.npz`` and then
  renamed (``os.replace``), so a reader never sees half a file;
* one entry a leaf, its key the leaf's path joined by ``/``, an item of a
  list or tuple named ``#i``; restore rebuilds the tree from the keys (no
  template), lists where every key of a node is ``#i``;
* ``manifest.json`` holds ``latest``, the largest step saved.

Empty subtrees write no entry: ``comm`` (the top-k residual tree) and a
stateless optimizer's ``opt_state`` restore as ``()``.

A port checkpoint holds the port's own layout (OIHW convolutions).  State
moves between the frameworks through ``repro_torch.bridge``
(``params_from_jax`` / ``params_to_jax``, which carry optimizer moments
too).  Restore returns tensors on an explicit device, CUDA unless the
caller asks for the CPU (``repro_torch.device.resolve_device``).

Deliberate difference: numpy has no bfloat16 of its own (the reference
writes such leaves through ``ml_dtypes``, which the port does not use), so a
bf16 leaf raises a ``TypeError`` that names it.  The port's train states
are f32: parameters, moments and the top-k residual.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any
_SEP = "/"


def _flatten(tree: Tree, prefix: tuple = ()) -> dict[str, np.ndarray]:
    """``{"a/b/#0": array}`` for every leaf of ``tree`` (dicts by sorted
    key, lists and tuples by index)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        key = _SEP.join(prefix)
        if isinstance(tree, torch.Tensor):
            if tree.dtype == torch.bfloat16:
                raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy cannot hold; "
                                "cast it to float32 first")
            return {key: tree.detach().cpu().numpy()}
        return {key: np.asarray(tree)}
    flat: dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten(flat: dict[str, np.ndarray], device: torch.device) -> Tree:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(val, device=device)
    return _lists(tree)


def _lists(node):
    """``{"#0": .., "#1": ..}`` nodes back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(re.fullmatch(r"#\d+", k) for k in node):
        return [node[f"#{i}"] for i in range(len(node))]
    return node


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Write ``tree`` (tensors, arrays or numbers) as step ``step``;
    returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    tmp = os.path.join(directory, f".tmp_step_{step:08d}.npz")
    final = os.path.join(directory, f"step_{step:08d}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    manifest = os.path.join(directory, "manifest.json")
    meta = {"latest": step}
    if os.path.exists(manifest):
        with open(manifest) as f:
            meta = json.load(f)
        meta["latest"] = max(meta.get("latest", -1), step)
    with open(manifest, "w") as f:
        json.dump(meta, f)
    return final


def latest_step(directory: str) -> int | None:
    """The largest step saved in ``directory``, or None."""
    manifest = os.path.join(directory, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return json.load(f).get("latest")


def restore_checkpoint(directory: str, step: int | None = None,
                       device: "torch.device | str | None" = None) -> tuple[Tree, int]:
    """``(tree, step)``: step ``step`` (default the latest) as a tree of
    tensors on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"step_{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat, dev), step


def save_train_state(directory: str, state) -> str:
    """Write a ``DecentralizedState``-shaped state (``params``,
    ``opt_state``, ``step``, ``comm``) at its step.  ``comm``, the codec's
    error-feedback residual, rides along, so a restored run resumes with the
    compression state it left with."""
    step = int(state.step)
    tree = {
        "params": state.params,
        "opt_state": state.opt_state,
        "step": np.asarray(step),
        "comm": getattr(state, "comm", ()),
    }
    return save_checkpoint(directory, step, tree)


def restore_train_state(directory: str, step: int | None = None,
                        device: "torch.device | str | None" = None) -> tuple[Tree, int]:
    """``(tree, step)`` with ``tree`` holding ``params``, ``opt_state``,
    ``step`` and ``comm`` as tensors on ``device`` (CUDA unless given);
    ``comm`` and ``opt_state`` are ``()`` where the run had none."""
    tree, step = restore_checkpoint(directory, step, device)
    tree.setdefault("comm", ())
    tree.setdefault("opt_state", ())
    return tree, step
