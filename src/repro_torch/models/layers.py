"""Shared layers of the LM zoo: plain functions over explicit param dicts.

Conventions are the reference's (``repro/models/layers.py``): activations
(B, S, d), attention heads (B, S, H, hd); weights keep the reference's
layouts (``wq`` (d, H, hd), ``wo`` (H, hd, d), ``w_gate`` (d, ff)) and are
cast to the compute dtype at each use; norms, softmax and rope run in f32.
Full-sequence attention (prefill and training) goes through
``repro_torch.kernels.flash_attention.FlashAttention``: the forward kernel
and, when an input needs a gradient, the backward kernel; single-token
decode attention stays plain PyTorch, as in the reference, which runs no
kernel there.
Sliding-window attention (the reference's ``_windowed_attention``) is not
ported yet: ``transformer.check_ported`` refuses windowed layers.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as fa

F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers (draws on the generator's device)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None) -> torch.Tensor:
    """N(0, 1) * scale, scale = 1/sqrt(fan_in) (fan_in = shape[0]) unless given."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=F32).mul_(scale)
    return x.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=F32).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + w) in f32 (w is initialised to zeros)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding of x (..., S, H, hd) at positions (S,)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions.to(F32)[..., :, None, None] * freqs  # (S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v) -> torch.Tensor:
    """Causal full-sequence attention.  q (B, S, H, hd), k, v (B, S, Hkv,
    hd) -> (B, S, H, hd) in q's dtype, through ``FlashAttention`` (GQA
    heads read in place, not expanded; differentiable on both devices)."""
    o = fa.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, *, length: int) -> torch.Tensor:
    """Single-token attention against a cache.  q (B, 1, H, hd); k/v_cache
    (B, S, Hkv, hd) of which the first ``length`` entries are valid."""
    B, _, H, hd = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float()[:, 0] * scale).reshape(B, Hkv, n_rep, hd)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float())  # (B, Hkv, rep, S)
    s = torch.where(torch.arange(Skv, device=q.device) < length, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    o = o / torch.clamp_min(l, 1e-30)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_params(gen, d_model, n_heads, n_kv_heads, head_dim, qk_norm, dtype) -> dict:
    p = {
        "wq": dense_init(gen, (d_model, n_heads, head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
        "wo": dense_init(gen, (n_heads, head_dim, d_model), dtype, scale=1.0 / math.sqrt(n_heads * head_dim)),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
    return p


def _proj(x, w, cd):
    """x (..., d) @ w (d, *out) -> (..., *out) with w cast to ``cd``."""
    return (x @ w.to(cd).reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def attention_qkv(p, x, positions, *, rope_theta, qk_norm, compute_dtype):
    q = _proj(x, p["wq"], compute_dtype)
    k = _proj(x, p["wk"], compute_dtype)
    v = _proj(x, p["wv"], compute_dtype)
    if qk_norm:  # the reference's default eps, not cfg.norm_eps
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v


def attention_out(p, o, compute_dtype):
    wo = p["wo"]
    return o.flatten(-2) @ wo.to(compute_dtype).reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(gen, d_model, d_ff, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp_apply(p, x, compute_dtype):
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(compute_dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits, labels, mask=None) -> torch.Tensor:
    """logits (..., V) f32 or bf16, labels (...) integer: the mean negative
    log-likelihood over the valid tokens (``mask`` nonzero), in f32."""
    logits = logits.float()
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = torch.logsumexp(logits, dim=-1) - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
