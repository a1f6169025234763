"""Byzantine attack models: the ``FaultModel`` protocol and its realizations.

Counterpart of ``repro.faults.models``.  A fault model rewrites the
*published* view of a masked agent's iterate before it is encoded onto the
wire, so the poisoned traffic goes through every codec and the DRT
statistics as honest traffic does.  An agent's own self term in the
combine keeps its true iterate: a Byzantine agent lies to its neighbours,
not to itself.

Models apply to tensors with an explicit agent axis under a ``(K,)`` bool
membership mask.  The Gauss models draw their noise with the reference's
``jax.random.normal`` stream (:func:`repro_torch.comm.prng.normal_at`,
within ``prng.NORMAL_ULPS`` ulps), keyed by round and by region or leaf,
and over the reference's layout:

* :func:`apply_fault_regions` (the slab paths): the reference draws over
  each region ``(n_slots, K, s_pad)``, lane padding included, keyed by
  ``fold_in(key, region)``; a region is one of the slab's groups, and each
  slab column's place in it comes from the layout's column maps (a conv
  weight's elements sit in another order here);
* :func:`apply_fault_tree` (the tree path): the reference draws over each
  agent-stacked leaf ``(K, ...)`` in its own layout, keyed by
  ``fold_in(key, leaf)``.

So, as in the reference, the slab's noise and the tree's noise differ.
Noise is drawn only for the masked agents' rows: a draw is a function of
its flat index.

Spec grammar (:func:`make_fault_model`):

- ``sign_flip``        -- publish ``-x``
- ``gauss:<sigma>``    -- publish ``x + sigma * N(0, I)``, independent per agent
- ``cgauss:<sigma>``   -- colluding: every Byzantine agent adds the same draw
- ``scale:<c>``        -- publish ``c * x``
- ``constant[:<v>]``   -- publish ``v`` everywhere (default ``v = 0``)
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.utils.pytree import Tree, reference_index, tree_items, tree_like

__all__ = [
    "FaultModel",
    "SignFlip",
    "GaussFault",
    "ScaleFault",
    "ConstantFault",
    "make_fault_model",
    "apply_fault_regions",
    "apply_fault_tree",
]


def _agent_broadcast(mask: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A (K,) mask shaped to broadcast along ``axis`` of an ``ndim`` tensor."""
    shape = [1] * ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


@runtime_checkable
class FaultModel(Protocol):
    """Rewrites the published view of masked agents' iterates."""

    name: str

    def apply(self, x: torch.Tensor, mask: torch.Tensor, key, axis: int = 0) -> torch.Tensor:
        """``x`` with the rows ``mask`` selects (along ``axis``) replaced by
        the faulted publication; a no-op where ``mask`` is False."""
        ...


@dataclasses.dataclass(frozen=True)
class SignFlip:
    """Publish the negated iterate."""

    name: str = dataclasses.field(default="sign_flip", init=False)

    def apply(self, x, mask, key, axis=0):
        del key
        return torch.where(_agent_broadcast(mask, x.dim(), axis), -x, x)


@dataclasses.dataclass(frozen=True)
class GaussFault:
    """Publish ``x + sigma * N(0, I)``; ``collude=True`` shares one draw
    across every Byzantine agent."""

    sigma: float
    collude: bool = False

    def __post_init__(self):
        if not self.sigma > 0.0:
            raise ValueError(f"gauss fault sigma must be > 0, got {self.sigma}")

    @property
    def name(self) -> str:
        return f"{'cgauss' if self.collude else 'gauss'}:{self.sigma:g}"

    def noisy(self, x: torch.Tensor, key, idx: torch.Tensor) -> torch.Tensor:
        """``x + sigma * normal(key)`` at the flat indices ``idx`` (shaped
        like ``x`` or broadcast to it), in ``x``'s dtype."""
        noise = prng.normal_at(key, idx) * float(np.float32(self.sigma))
        return (x.float() + noise).to(x.dtype)

    def apply(self, x, mask, key, axis=0):
        shape = list(x.shape)
        if self.collude:
            shape[axis] = 1
        n = int(np.prod(shape, dtype=np.int64))
        idx = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
        return torch.where(_agent_broadcast(mask, x.dim(), axis), self.noisy(x, key, idx), x)


@dataclasses.dataclass(frozen=True)
class ScaleFault:
    """Publish ``c * x``."""

    c: float

    @property
    def name(self) -> str:
        return f"scale:{self.c:g}"

    def apply(self, x, mask, key, axis=0):
        del key
        faulted = (x.float() * float(np.float32(self.c))).to(x.dtype)
        return torch.where(_agent_broadcast(mask, x.dim(), axis), faulted, x)


@dataclasses.dataclass(frozen=True)
class ConstantFault:
    """Publish the constant ``value`` everywhere."""

    value: float = 0.0

    @property
    def name(self) -> str:
        return f"constant:{self.value:g}"

    def apply(self, x, mask, key, axis=0):
        del key
        return torch.where(_agent_broadcast(mask, x.dim(), axis), torch.full_like(x, self.value), x)


def make_fault_model(spec) -> FaultModel:
    """Parse a fault-model spec (module docstring) into a ``FaultModel``;
    an already-built model (anything with ``.apply``) passes through."""
    if hasattr(spec, "apply"):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"fault model spec must be a string or FaultModel, got {spec!r}")
    head, _, rest = spec.partition(":")
    if head == "sign_flip":
        return SignFlip()
    if head in ("gauss", "cgauss"):
        if not rest:
            raise ValueError(f"'{head}' fault needs a sigma, e.g. '{head}:0.5'")
        return GaussFault(sigma=float(rest), collude=head == "cgauss")
    if head == "scale":
        if not rest:
            raise ValueError("'scale' fault needs a factor, e.g. 'scale:10'")
        return ScaleFault(c=float(rest))
    if head == "constant":
        return ConstantFault(value=float(rest) if rest else 0.0)
    raise ValueError(
        f"unknown fault model {spec!r} "
        "(expected sign_flip | gauss:<sigma> | cgauss:<sigma> | scale:<c> | constant[:<v>])"
    )


def _rows(mask: torch.Tensor, rows) -> np.ndarray:
    """The masked agents as host indices (read off ``mask`` when not given)."""
    if rows is None:
        rows = mask.cpu().numpy()
    rows = np.asarray(rows)
    return np.flatnonzero(rows) if rows.dtype == bool else rows.astype(np.int64)


def apply_fault_regions(model: FaultModel, layout, slab: torch.Tensor, mask: torch.Tensor, key, rows=None):
    """``model`` on a (K, D) slab, each group as the reference's region of
    the same index.  A deterministic model is one elementwise pass over the
    whole slab (lane padding included, as over the reference's regions); a
    Gauss model draws the reference's region noise of the masked rows
    only, in one draw over every column: column ``c`` of group ``g`` under
    ``fold_in(key, g)`` at its place in the region
    (``layout.region_maps_on``).  ``rows``: the masked agents on the host
    (a (K,) bool array or indices), read off ``mask`` when not given.
    Returns a new slab (or ``slab`` itself when no agent is masked and the
    model draws noise)."""
    if not isinstance(model, GaussFault):
        return model.apply(slab, mask, key, axis=0)
    rows = _rows(mask, rows)
    if rows.size == 0:
        return slab
    K = slab.shape[0]
    maps = layout.region_maps_on(slab.device)
    keys = prng.keys_tensor(prng.fold_in(key, np.arange(len(layout.groups))), slab.device)[maps["group"]]
    if model.collude:  # region shape (n_slots, 1, s_pad)
        idx = (maps["slot"] * maps["s_pad"] + maps["col"])[None]
    else:  # (n_slots, K, s_pad): element (j, k, c) at (j K + k) s_pad + c
        r_t = torch.as_tensor(rows, device=slab.device)
        idx = (maps["slot"][None] * K + r_t[:, None]) * maps["s_pad"] + maps["col"]
    out = slab.clone()
    out[rows] = model.noisy(slab[rows], keys, idx)
    return out


def apply_fault_tree(model: FaultModel, tree: Tree, mask: torch.Tensor, key, rows=None) -> Tree:
    """``model`` on every floating leaf of an agent-stacked tree (agent axis
    0), leaf ``i`` (full-tree order) under ``fold_in(key, i)``; a Gauss
    model draws the reference's noise of each leaf ``(K, ...)`` at each
    element's place in the reference's layout, for the masked rows only."""
    gauss = isinstance(model, GaussFault)
    if gauss:
        rows = _rows(mask, rows)
    out = []
    for i, (path, leaf) in enumerate(tree_items(tree)):
        if not leaf.is_floating_point():
            out.append(leaf)
        elif not gauss:
            out.append(model.apply(leaf, mask, prng.fold_in(key, i), axis=0))
        elif rows.size == 0:
            out.append(leaf)
        else:
            n = leaf[0].numel()
            ref = torch.as_tensor(reference_index(path, tuple(leaf.shape[1:])), device=leaf.device)
            r_t = torch.as_tensor(rows, device=leaf.device)
            lead = r_t.reshape(-1, *([1] * ref.dim())) * n
            idx = ref[None] if model.collude else lead + ref[None]
            new = leaf.clone()
            new[r_t] = model.noisy(leaf[r_t], prng.fold_in(key, i), idx)
            out.append(new)
    return tree_like(tree, out)
