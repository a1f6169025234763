"""Functional optimizers over parameter trees.

Counterpart of ``repro.optim.optimizers`` (``sgd``, ``momentum``, ``adamw``,
``clip_by_global_norm``, ``chain``) with the same formulas: AdamW's bias correction counts from ``step + 1`` in
float32 and its moments are float32.  An ``Optimizer`` is a pair of
functions:

  init(params) -> opt_state
  update(grads, opt_state, params, step) -> (new_params, new_opt_state)

Every transform is elementwise over leaves, so it applies unchanged to
agent-stacked trees: each agent gets its own optimizer state.  ``update``
returns new tensors and leaves its inputs untouched.  Learning rates are
floats or ``schedule(step) -> float`` callables.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

Tree = Any


def _as_schedule(lr) -> Callable[[int], float]:
    if callable(lr):
        return lr
    return lambda step: float(lr)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, int], tuple[Tree, Tree]]


def sgd(lr) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        lr_t = lr(step)
        return tree_map(lambda p, g: p - lr_t * g.to(p.dtype), params, grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        lr_t = lr(step)
        m = tree_map(lambda m_, g: beta * m_ + g.to(m_.dtype), state["m"], grads)
        upd = tree_map(lambda m_, g: beta * m_ + g.to(m_.dtype), m, grads) if nesterov else m
        new_params = tree_map(lambda p, u: p - lr_t * u.to(p.dtype), params, upd)
        return new_params, {"m": m}

    return Optimizer(init, update)


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr_t = lr(step)
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(), state["v"], grads)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(inner: Optimizer, max_norm: float) -> Optimizer:
    """``inner`` with global-norm gradient clipping, as the reference: the
    norm is taken over every leaf of the gradient tree, so on an
    agent-stacked tree over all K agents together (one scale for every
    agent), in f32."""

    def init(params):
        return inner.init(params)

    def update(grads, state, params, step):
        sq = torch.stack([g.float().square().sum() for g in tree_leaves(grads)])
        gn = torch.sqrt(sq.sum())
        scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return inner.update(grads, state, params, step)

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    """Apply optimizers in turn, each on the parameters the previous one
    returned, with the same gradients."""

    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params, step):
        new_state = []
        for o, s in zip(opts, state):
            params, s = o.update(grads, s, params, step)
            new_state.append(s)
        return params, tuple(new_state)

    return Optimizer(init, update)
