"""Functional optimizers over parameter trees.

Counterpart of ``repro.optim.optimizers`` (``sgd``, ``momentum``, ``adamw``,
``clip_by_global_norm``, ``chain``) with the same formulas: AdamW's bias correction counts from ``step + 1`` in
float32 and its moments are float32.  An ``Optimizer`` is a pair of
functions and the functional form made from them:

  init(params) -> opt_state
  update_(grads, opt_state, params, step) -> None
  update(grads, opt_state, params, step) -> (new_params, new_opt_state)

Every transform is elementwise over leaves, so it applies unchanged to
agent-stacked trees: each agent gets its own optimizer state.  ``update_``
writes the new parameters and state into ``params`` and ``opt_state``:
the LM train step's update, which the reference's jitted step donates, so
that a second copy of the parameters and moments never exists (four
qwen3-4b agents hold 15.7 GB of each).  ``update`` runs it on copies and
returns them, leaving its inputs untouched, the same numbers bit for bit.
Neither writes to ``grads``.  Learning rates are floats or
``schedule(step) -> float`` callables.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import container_map, tree_leaves, tree_map

Tree = Any


def _as_schedule(lr) -> Callable[[int], float]:
    if callable(lr):
        return lr
    return lambda step: float(lr)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update_: Callable[[Tree, Tree, Tree, int], None]

    def update(self, grads, opt_state, params, step):
        """The functional form: ``update_`` on copies of ``params`` and
        ``opt_state``, returned as ``(new_params, new_opt_state)``."""
        params, opt_state = (container_map(torch.clone, t) for t in (params, opt_state))
        self.update_(grads, opt_state, params, step)
        return params, opt_state


def sgd(lr) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return ()

    def update_(grads, state, params, step):
        lr_t = lr(step)
        tree_map(lambda p, g: p.sub_(lr_t * g.to(p.dtype)), params, grads)

    return Optimizer(init, update_)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update_(grads, state, params, step):
        lr_t = lr(step)

        def leaf(p, m_, g):
            m_.mul_(beta).add_(g.to(m_.dtype))
            u = beta * m_ + g.to(m_.dtype) if nesterov else m_
            p.sub_(lr_t * u.to(p.dtype))

        tree_map(leaf, params, state["m"], grads)

    return Optimizer(init, update_)


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

    def update_(grads, state, params, step):
        lr_t = lr(step)
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)

        def leaf(p, m_, v_, g):
            m_.mul_(b1).add_((1 - b1) * g.float())
            v_.mul_(b2).add_((1 - b2) * g.float().square())
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr_t * u)

        tree_map(leaf, params, state["m"], state["v"], grads)

    return Optimizer(init, update_)


def clip_by_global_norm(inner: Optimizer, max_norm: float) -> Optimizer:
    """``inner`` with global-norm gradient clipping, as the reference: the
    norm is taken over every leaf of the gradient tree, so on an
    agent-stacked tree over all K agents together (one scale for every
    agent), in f32.  The inner update reads scaled copies of the
    gradients (a chain hands the caller's to its next part)."""

    def init(params):
        return inner.init(params)

    def update_(grads, state, params, step):
        sq = torch.stack([g.float().square().sum() for g in tree_leaves(grads)])
        gn = torch.sqrt(sq.sum())
        scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
        inner.update_(tree_map(lambda g: g * scale.to(g.dtype), grads), state, params, step)

    return Optimizer(init, update_)


def chain(*opts: Optimizer) -> Optimizer:
    """Apply optimizers in turn, each on the parameters the previous one
    returned, with the same gradients."""

    def init(params):
        return tuple(o.init(params) for o in opts)

    def update_(grads, state, params, step):
        for o, s in zip(opts, state):
            o.update_(grads, s, params, step)

    return Optimizer(init, update_)
