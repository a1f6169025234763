"""DRT diffusion combination weights (paper §II, eqs. 12-14).

Counterpart of ``repro.core.drt``: the dense pipeline and its edge-list
factorization (``drt_edge_mixing``, ``edge_mixing_dense``).  Everything runs in
log space: with many layers the raw product ``2^(L+1) * prod_p (1 + d2_p /
(n2_p + kappa))`` overflows float32, so the code carries ``log(a~)`` and
normalizes with a shifted exponential.  Non-edges carry the same ``-1e30``
sentinel as the reference.

Index conventions (matching the paper):
  d2[p, l, k] = || w_k^(p) - w_l^(p) ||^2   (symmetric in l, k)
  n2[p, l]    = || w_l^(p) ||^2
  A[p, l, k]  = weight that agent k applies to psi_l for layer p.
Columns (fixed k, summing over l) are stochastic: sum_l A[p, l, k] = 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

_NEG_INF = -1e30

WeightMode = Literal["paper", "exact_grad"]


@dataclasses.dataclass(frozen=True)
class DRTConfig:
    """Hyper-parameters of the DRT mixing-matrix construction.

    ``N``: clip factor of eq. (13); ``None`` gives the paper's N = 2K.
    ``kappa``: numerical-stability constant of eq. (10).
    ``weight_mode``: 'paper' implements eq. (14) as printed (denominator
    d2 + kappa); 'exact_grad' uses the true gradient of the penalty in (10)
    (denominator n2 + kappa + d2).
    """

    N: float | None = None
    kappa: float = 1e-6
    weight_mode: WeightMode = "paper"

    def resolve_N(self, K: int) -> float:
        return float(2 * K) if self.N is None else float(self.N)


def drt_log_unnormalized(
    d2: torch.Tensor,
    n2: torch.Tensor,
    C: torch.Tensor,
    kappa: float,
    weight_mode: WeightMode = "paper",
) -> torch.Tensor:
    """log a~_{lk}^{(p)} for l != k (eq. 14); the sentinel on non-edges and
    on the diagonal.  d2: (L, K, K), n2: (L, K), C: (K, K).  Returns
    (L, K, K)."""
    L, K = d2.shape[0], d2.shape[1]
    d2 = d2.float()
    n2 = n2.float()
    ratio = d2 / (n2[:, :, None] + kappa)
    log_prod = torch.log1p(ratio).sum(0) + (L + 1) * math.log(2.0)  # (K, K)
    if weight_mode == "paper":
        log_denom = torch.log(d2 + kappa)
    elif weight_mode == "exact_grad":
        log_denom = torch.log(n2[:, :, None] + kappa + d2)
    else:
        raise ValueError(f"unknown weight_mode {weight_mode!r}")
    log_a = log_prod[None] - log_denom + torch.log(C)[None]
    eye = torch.eye(K, dtype=torch.bool, device=d2.device)
    edge_mask = (C > 0) & ~eye
    return torch.where(edge_mask[None], log_a, torch.full_like(log_a, _NEG_INF))


def drt_clip_and_self(log_a: torch.Tensor, C: torch.Tensor, N: float) -> torch.Tensor:
    """Eq. (13): clip off-diagonal entries at N x (smallest positive entry
    of the column), then set the self weight to c_kk/(n_k - 1) x the sum of
    the rest.  In log space; returns (L, K, K) including the diagonal."""
    K = log_a.shape[1]
    eye = torch.eye(K, dtype=torch.bool, device=log_a.device)
    edge_mask = ((C > 0) & ~eye)[None]
    neg = torch.full_like(log_a, _NEG_INF)
    log_min = torch.where(edge_mask, log_a, -neg).amin(dim=1, keepdim=True)
    log_clipped = torch.minimum(log_a, math.log(N) + log_min)
    log_clipped = torch.where(edge_mask, log_clipped, neg)
    n_k = (C > 0).sum(0).float()  # includes the self loop
    c_kk = torch.diagonal(C).float()
    denom = torch.clamp(n_k - 1.0, min=1.0)
    log_sum = torch.logsumexp(log_clipped, dim=1)  # (L, K); non-edges hold -1e30
    log_self = torch.log(c_kk / denom)[None, :] + log_sum
    return torch.where(eye[None], log_self[:, None, :].expand_as(log_clipped), log_clipped)


def drt_normalize(log_a: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Eq. (12): column normalization with a shifted exponential."""
    mask = (C > 0)[None]
    masked = torch.where(mask, log_a, torch.full_like(log_a, _NEG_INF))
    m = masked.amax(dim=1, keepdim=True)
    ex = torch.where(mask, torch.exp(masked - m), torch.zeros_like(masked))
    return ex / ex.sum(dim=1, keepdim=True)


def drt_mixing_matrices(
    d2: torch.Tensor, n2: torch.Tensor, C: torch.Tensor, cfg: DRTConfig
) -> torch.Tensor:
    """Eqs. (12)-(14): distances -> A (L, K, K), column-stochastic over axis
    1 and supported on the graph of C."""
    K = d2.shape[1]
    C = torch.as_tensor(C, dtype=torch.float32, device=d2.device)
    log_a = drt_log_unnormalized(d2, n2, C, cfg.kappa, cfg.weight_mode)
    log_full = drt_clip_and_self(log_a, C, cfg.resolve_N(K))
    return drt_normalize(log_full, C)


# -- the sparse (edge-list) factorization of eqs. (12)-(14) ---------------------


def edge_log_constants(num_layers: int, N: float) -> tuple[float, float]:
    """``(log N, (L + 1) log 2)`` rounded to f32 as the reference computes
    them (``jnp.log`` of an f32 constant, an f32 product)."""
    log2 = np.log(np.float32(2.0))
    return float(np.log(np.float32(N))), float(np.float32(num_layers + 1) * log2)


def drt_edge_mixing(d2_e, n2, src, dst, w, cfg: DRTConfig, K: int):
    """Eqs. (12)-(14) on a padded directed edge list, O(|E| L).

    ``d2_e`` (L, E): per-layer ``||x_src - x_dst||^2``; ``n2`` (L, K);
    ``src``/``dst``/``w`` (E,) (``w == 0`` marks padding).  Every
    per-column reduction of the dense pipeline becomes a segment reduce
    keyed on ``dst``, mirroring the reference's ``.at[:, dst]`` min, max and
    add.  Returns ``(A_self (L, K), A_e (L, E))``, column-stochastic: an
    isolated agent gets ``A_self = 1``."""
    L, E = d2_e.shape
    dev = d2_e.device
    d2_e, n2 = d2_e.float(), n2.float()
    w = w.float()
    src_l = src.long()
    dst_e = dst.long().expand(L, E)
    mask = w > 0.0
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=dev)

    # eq. (14) per edge, against the SOURCE agent's layer norms
    ratio = d2_e / (n2[:, src_l] + cfg.kappa)
    log_n, log2_l1 = edge_log_constants(L, cfg.resolve_N(K))
    log_prod = torch.log1p(ratio).sum(0) + log2_l1  # (E,)
    if cfg.weight_mode == "paper":
        log_denom = torch.log(d2_e + cfg.kappa)
    elif cfg.weight_mode == "exact_grad":
        log_denom = torch.log(n2[:, src_l] + cfg.kappa + d2_e)
    else:
        raise ValueError(f"unknown weight_mode {cfg.weight_mode!r}")
    log_w = torch.log(torch.where(mask, w, 1.0))
    log_a = torch.where(mask[None], log_prod[None, :] - log_denom + log_w[None, :], neg)

    # eq. (13) clip: smallest edge weight per (layer, dst) column
    log_min = torch.full((L, K), -_NEG_INF, dtype=torch.float32, device=dev).scatter_reduce(
        1, dst_e, torch.where(mask[None], log_a, -neg), "amin", include_self=True
    )
    log_clipped = torch.minimum(log_a, log_n + log_min[:, dst.long()])
    log_clipped = torch.where(mask[None], log_clipped, neg)

    # self weight c_kk/(n_k - 1) x the sum of the clipped in-edges (a
    # two-pass segment logsumexp: max shift, then sum)
    n_k = 1.0 + torch.zeros(K, dtype=torch.float32, device=dev).index_add_(0, dst.long(), mask.float())
    denom = torch.clamp(n_k - 1.0, min=1.0)
    m1 = torch.full((L, K), _NEG_INF, dtype=torch.float32, device=dev).scatter_reduce(
        1, dst_e, torch.where(mask[None], log_clipped, neg), "amax", include_self=True
    )
    sumexp = torch.zeros(L, K, dtype=torch.float32, device=dev).index_add_(
        1, dst.long(), torch.where(mask[None], torch.exp(log_clipped - m1[:, dst.long()]), 0.0)
    )
    log_sum = torch.where(sumexp > 0.0, m1 + torch.log(torch.clamp(sumexp, min=1e-30)), neg)
    log_self = -torch.log(denom)[None, :] + log_sum  # c_kk == 1 on the support

    # eq. (12): shifted exponentials over {self} u {in-edges}
    m = torch.maximum(log_self, m1)
    a_self = torch.exp(log_self - m)
    a_e = torch.where(mask[None], torch.exp(log_clipped - m[:, dst.long()]), 0.0)
    colsum = a_self + torch.zeros(L, K, dtype=torch.float32, device=dev).index_add_(1, dst.long(), a_e)
    return a_self / colsum, a_e / colsum[:, dst.long()]


def edge_mixing_dense(A_self, A_e, src, dst, w, K: int) -> torch.Tensor:
    """Edge-factorized mixing weights as dense (L, K, K) matrices,
    ``A[p, l, k]`` the weight agent k applies to psi_l."""
    L = A_self.shape[0]
    vals = torch.where(w.float()[None] > 0.0, A_e, 0.0)
    A = torch.zeros(L, K * K, dtype=A_self.dtype, device=A_self.device)
    A.index_add_(1, src.long() * K + dst.long(), vals)
    A = A.view(L, K, K)
    torch.diagonal(A, dim1=1, dim2=2).copy_(A_self)
    return A
