"""Robust aggregation: trust reweighting and the non-DRT combines.

Counterpart of ``repro.faults.robust``.  Trust reweighting post-processes
the eq. 12-14 mixing weights (or the Metropolis weights), every column
staying stochastic:

- **temperature** (``temp``; below 1 sharpens): each column's off-diagonal
  entries are raised to ``1/temp`` and renormalized to the same total
  off-diagonal mass;
- **clipping** (``clip``): any single neighbour's column entry is capped at
  ``clip``, the excess moving to the agent's own diagonal entry.  This is
  the Byzantine defense: eq. 14's floor gives every neighbour, poisoned or
  not, some weight, and the clip bounds what a lying neighbour can inject
  on top of DRT's own down-weighting.

The robust combines (coordinate-wise trimmed mean and median over the
closed neighbourhood) are the classical non-DRT baselines: they ignore the
mixing weights and work on the decoded published values.  They are plain
PyTorch here (``torch.sort``), as they are plain jnp in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "parse_combine",
    "validate_trust_knobs",
    "reweight_dense",
    "reweight_edge",
    "reweight_local",
    "robust_combine",
    "support_uniform",
]

_TINY = 1e-12
_BIG = 1e30  # masked-sort sentinel: finite, so a 0 rank weight keeps it out


def parse_combine(spec) -> tuple:
    """A combine spec as ``(kind, frac)``: ``drt`` (the weighted combine,
    DRT or Metropolis; the default) | ``trimmed:<f>`` (coordinate-wise
    trimmed mean, trimming the fraction ``f`` from each end of the
    neighbourhood) | ``median``."""
    if spec is None or spec == "drt":
        return ("drt", None)
    if spec == "median":
        return ("median", None)
    head, _, rest = str(spec).partition(":")
    if head == "trimmed":
        if not rest:
            raise ValueError("'trimmed' combine needs a fraction, e.g. 'trimmed:0.25'")
        f = float(rest)
        if not 0.0 <= f < 0.5:
            raise ValueError(f"trimmed fraction must be in [0, 0.5), got {f}")
        return ("trimmed", f)
    raise ValueError(f"unknown combine {spec!r} (expected drt | trimmed:<f> | median)")


def validate_trust_knobs(clip, temp) -> None:
    if clip is not None and not 0.0 < clip <= 1.0:
        raise ValueError(f"trust_clip must be in (0, 1], got {clip}")
    if temp is not None and not temp > 0.0:
        raise ValueError(f"trust_temp must be > 0, got {temp}")


def _sharpen(w: torch.Tensor, mass: torch.Tensor, dim: int, temp: float) -> torch.Tensor:
    """``w``'s entries to the power ``1/temp``, renormalized along ``dim``
    to the total ``mass``."""
    p = w / torch.clamp(mass, min=_TINY)
    p = p ** float(np.float32(1.0 / temp))
    return p / torch.clamp(p.sum(dim, keepdim=True), min=_TINY) * mass


def reweight_dense(A: torch.Tensor, clip=None, temp=None) -> torch.Tensor:
    """Temperature-sharpen, then clip, a column-stochastic (..., K, K)
    mixing stack ``A[..., l, k]`` (the weight agent k gives agent l); the
    clip's excess moves to the diagonal, so columns stay stochastic."""
    validate_trust_knobs(clip, temp)
    K = A.shape[-1]
    eye = torch.eye(K, dtype=A.dtype, device=A.device)
    off = A * (1.0 - eye)
    diag = A * eye
    if temp is not None:
        off = _sharpen(off, off.sum(-2, keepdim=True), -2, temp)
    if clip is not None:
        over = torch.clamp(off - clip, min=0.0)
        off = torch.clamp(off, max=clip)
        diag = diag + eye * over.sum(-2, keepdim=True)
    return off + diag


def reweight_edge(A_self: torch.Tensor, A_e: torch.Tensor, dst: torch.Tensor, K: int, clip=None, temp=None):
    """The edge path's form of :func:`reweight_dense`: ``A_self`` (L, K)
    the agents' own weights, ``A_e`` (L, E) the directed edges' weights,
    each edge in its destination ``dst`` (E,)'s column; padding edges have
    weight 0 and keep it.  The temperature renormalizes each destination's
    in-edges to their total, the clip moves each edge's excess to its
    destination's own weight.  Returns the reweighted ``(A_self, A_e)``."""
    validate_trust_knobs(clip, temp)
    dst = dst.long()

    def per_dst(x):  # (L, E) -> (L, K): the sums over each destination's in-edges
        return torch.zeros(x.shape[0], K, dtype=x.dtype, device=x.device).index_add_(1, dst, x)

    if temp is not None:
        mass = per_dst(A_e)[:, dst]
        p = (A_e / torch.clamp(mass, min=_TINY)) ** float(np.float32(1.0 / temp))
        A_e = p / torch.clamp(per_dst(p)[:, dst], min=_TINY) * mass
    if clip is not None:
        over = torch.clamp(A_e - clip, min=0.0)
        A_e = torch.clamp(A_e, max=clip)
        A_self = A_self + per_dst(over)
    return A_self, A_e


def reweight_local(w_self: torch.Tensor, w_nbrs: torch.Tensor, clip=None, temp=None):
    """The permute engine's form: ``w_self`` (L,) the agent's own weight,
    ``w_nbrs`` (n, L) its neighbours' (zeros for phantom pairs, which stay
    zero).  Returns the reweighted ``(w_self, w_nbrs)``."""
    validate_trust_knobs(clip, temp)
    if temp is not None:
        w_nbrs = _sharpen(w_nbrs, w_nbrs.sum(0, keepdim=True), 0, temp)
    if clip is not None:
        over = torch.clamp(w_nbrs - clip, min=0.0)
        w_nbrs = torch.clamp(w_nbrs, max=clip)
        w_self = w_self + over.sum(0)
    return w_self, w_nbrs


def support_uniform(C: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(L, K, K) column-stochastic uniform weights over the support of ``C``:
    the stand-in mixing matrix (``A_last``, telemetry) of the robust
    combines."""
    S = (torch.as_tensor(C) > 0).float()
    A = S / torch.clamp(S.sum(0, keepdim=True), min=1.0)
    return A.expand(num_layers, *A.shape)


def _rank_weights(deg: torch.Tensor, kind: str, frac) -> torch.Tensor:
    """(K_dst, K) weights over each destination's sorted neighbourhood
    values: the trimmed mean's middle ranks or the median's one or two."""
    K = deg.shape[0]
    idx = torch.arange(K, device=deg.device)[None]
    n = deg[:, None]
    if kind == "trimmed":
        g = torch.minimum(torch.floor(float(np.float32(frac)) * n.float()).long(),
                          torch.clamp((n - 1) // 2, min=0))
        w = ((idx >= g) & (idx < n - g)).float()
    elif kind == "median":
        w = ((idx == (n - 1) // 2) | (idx == n // 2)).float()
    else:
        raise ValueError(f"unknown robust combine kind {kind!r}")
    return w / torch.clamp(w.sum(1, keepdim=True), min=1.0)


def robust_combine(C: torch.Tensor, x: torch.Tensor, kind: str, frac) -> torch.Tensor:
    """Coordinate-wise trimmed mean or median of a (K, D) slab of decoded
    published values: for every destination ``k``, each column aggregated
    over the closed neighbourhood ``{l : C[l, k] > 0}`` (its own value
    included) by a masked sort along the agents, non-members sorting to the
    top under a finite sentinel with zero rank weight.  ``trimmed`` drops
    ``floor(frac n_k)`` values from each end (at least one kept),
    ``median`` keeps the middle rank(s).  Dense in K (a (K, D, K) sort):
    the robust baselines' path, not a hot path.  Returns a new f32 slab."""
    S = torch.as_tensor(C, device=x.device) > 0
    W = _rank_weights(S.sum(0), kind, frac)  # (K_dst, K)
    xt = x.float().t()  # (D, K): agents last, the sort's axis
    v = torch.where(S.t()[:, None, :], xt[None], _BIG)  # (K_dst, D, K)
    v = torch.sort(v, dim=-1).values
    return (v * W[:, None, :]).sum(-1)
