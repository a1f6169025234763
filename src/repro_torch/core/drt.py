"""DRT diffusion combination weights (paper §II, eqs. 12-14).

Counterpart of ``repro.core.drt`` (the dense pipeline).  Everything runs in
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
