"""Generic decoder-LM engine: the ``attn_mlp`` and ``mamba`` layer kinds.

Parameters are stacked per group along a leading repeat axis, as in the
reference (``repro/models/transformer.py``); the reference scans over that
axis, the port loops over it in Python (PyTorch runs eagerly).  Serving is
prefill (the whole prompt: attention through the ``flash_attention``
kernel, Mamba through the ``selective_scan`` kernel) then one
``decode_step`` per token against per-layer caches: full-attention layers
hold a (B, max_len, Hkv, hd) KV cache, Mamba layers an O(1) conv and scan
state.  ``decode_step`` writes the new KV entries into the caches IN PLACE
(the reference returns updated copies), which saves a copy of every cache
per token; the caches it returns are the ones it was given.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import GroupCfg, LayerCfg, ModelConfig
from repro_torch.models.layers import (
    attention_out,
    attention_params,
    attention_qkv,
    decode_attention,
    dense_init,
    embed_init,
    flash_attention,
    mlp_apply,
    mlp_params,
    rms_norm,
)
from repro_torch.utils.pytree import tree_items, tree_map

PORTED_KINDS = ("attn_mlp", "mamba")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer the port does not run yet."""
    for g in cfg.groups:
        if len(g.unit) != 1:
            raise NotImplementedError(
                f"group {g.name!r} of {cfg.name} repeats a unit of {len(g.unit)} sub-layers; patterned "
                "units are not ported yet (ROADMAP.md, Queue 1 #12)"
            )
        for lc in g.unit:
            if lc.kind not in PORTED_KINDS:
                raise NotImplementedError(
                    f"layer kind {lc.kind!r} of {cfg.name} is not ported yet (ROADMAP.md, Queue 1 #12)"
                )
            if lc.window is not None:
                raise NotImplementedError(
                    f"sliding-window attention (window={lc.window}) of {cfg.name} is not ported yet "
                    "(ROADMAP.md, Queue 1 #12)"
                )


# ---------------------------------------------------------------------------
# parameter init (on the generator's device)
# ---------------------------------------------------------------------------


def _layer_params(gen, cfg: ModelConfig, lc: LayerCfg) -> dict:
    d, dtype = cfg.d_model, cfg.pdtype
    zeros = lambda: torch.zeros(d, dtype=dtype, device=gen.device)  # noqa: E731
    if lc.kind == "attn_mlp":
        a = cfg.attn
        return {
            "ln1": zeros(),
            "ln2": zeros(),
            "attn": attention_params(gen, d, a.n_heads, a.n_kv_heads, a.head_dim, a.qk_norm, dtype),
            "mlp": mlp_params(gen, d, cfg.d_ff, dtype),
        }
    return {"ln": zeros(), "mamba": ssm_mod.mamba_params(gen, d, cfg.ssm, dtype)}  # "mamba" (check_ported)


def _stacked(make, repeat: int) -> dict:
    """``repeat`` draws of ``make()`` stacked along a new leading axis, filled
    one draw at a time (peak: the stack plus one draw, not two stacks)."""
    first = make()
    out = tree_map(lambda x: x.new_empty((repeat, *x.shape)), first)
    for r in range(repeat):
        draw = first if r == 0 else make()
        for (_, dst), (_, src) in zip(tree_items(out), tree_items(draw)):
            dst[r].copy_(src)
        del draw
    return out


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights with the reference's distributions, drawn from ``gen``
    on its device (so a full-width model is made on the card)."""
    check_ported(cfg)
    params: dict = {"embed": {"tok": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype)}}
    for g in cfg.groups:
        params[g.param_key] = _stacked(lambda g=g: _layer_params(gen, cfg, g.unit[0]), g.repeat)
    params["final_norm"] = {"w": torch.zeros(cfg.d_model, dtype=cfg.pdtype, device=gen.device)}
    params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype)}
    return params


# ---------------------------------------------------------------------------
# layer iteration and the full-sequence forward
# ---------------------------------------------------------------------------


class LayerRef(NamedTuple):
    group: GroupCfg
    rep: int
    lc: LayerCfg


def iter_layers(cfg: ModelConfig) -> Iterator[LayerRef]:
    for g in cfg.groups:
        for r in range(g.repeat):
            yield LayerRef(g, r, g.unit[0])


def _layer_param_slice(params, ref: LayerRef) -> dict:
    """One layer's weights: views into the stacked group (no copy)."""
    return tree_map(lambda x: x[ref.rep], params[ref.group.param_key])


def _attn_block(p, x, cfg: ModelConfig, positions):
    """Pre-norm attention + MLP over the full sequence; returns the new
    hidden states and the layer's (k, v) for the cache."""
    a, cd = cfg.attn, cfg.cdtype
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attention_qkv(p["attn"], h, positions, rope_theta=a.rope_theta, qk_norm=a.qk_norm,
                            compute_dtype=cd)
    x = x + attention_out(p["attn"], flash_attention(q, k, v), cd)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cd), (k, v)


def _mamba_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    out, state = _mamba_prefill(p["mamba"], h, cfg)
    return x + out, state


def decoder_stack(params, x, cfg: ModelConfig):
    """All layers over hidden states x (B, S, d)."""
    positions = torch.arange(x.shape[1], device=x.device)
    for ref in iter_layers(cfg):
        p = _layer_param_slice(params, ref)
        if ref.lc.kind == "attn_mlp":
            x, _ = _attn_block(p, x, cfg, positions)
        else:
            x, _ = _mamba_block(p, x, cfg)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig):
    # gather, then cast: the same numbers as the reference's cast-then-gather
    return params["embed"]["tok"][tokens].to(cfg.cdtype)


def unembed(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x @ params["lm_head"]["w"].to(cfg.cdtype)


def forward(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype."""
    check_ported(cfg)
    x = decoder_stack(params, embed_tokens(params, tokens, cfg), cfg)
    return unembed(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, B: int, max_len: int, device=None) -> list[dict]:
    """One cache dict per layer: ``k``/``v`` (B, max_len, Hkv, hd) in the
    compute dtype for attention, ``conv``/``ssm`` (f32) for Mamba."""
    a = cfg.attn
    caches = []
    for ref in iter_layers(cfg):
        if ref.lc.kind == "attn_mlp":
            shape = (B, max_len, a.n_kv_heads, a.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                           "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)})
        else:
            caches.append(ssm_mod.mamba_init_state(B, cfg.d_model, cfg.ssm, device))
    return caches


def _ring_fill(cache_kv, kv, S: int):
    """Write the prompt's kv (B, S, Hkv, hd) into a full-attention cache
    (B, W, Hkv, hd) at the decode slots 0..S-1 (slot = position), in place;
    the cache must hold the whole prompt.  (The reference's ring buffers of
    windowed layers wrap at W; windowed layers are not ported.)"""
    W = cache_kv.shape[1]
    if W < S:
        raise ValueError(f"full-attention KV cache too small: max_len={W} < prefill len {S}")
    cache_kv[:, :S] = kv.to(cache_kv.dtype)
    return cache_kv


def _mamba_prefill(p, h, cfg: ModelConfig):
    """Mamba over the full prompt: output and the decode state after it."""
    return ssm_mod.mamba_apply(p, h, cfg.ssm, cfg.d_model, cfg.cdtype)


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """The whole prompt at once, building the decode caches.

    Returns ``(logits of the LAST position (B, 1, V), caches, next_pos)``."""
    check_ported(cfg)
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)
    caches = init_caches(cfg, B, max_len, device=x.device)
    for i, ref in enumerate(iter_layers(cfg)):
        p = _layer_param_slice(params, ref)
        if ref.lc.kind == "attn_mlp":
            x, (k, v) = _attn_block(p, x, cfg, positions)
            _ring_fill(caches[i]["k"], k, S)
            _ring_fill(caches[i]["v"], v, S)
        else:
            x, caches[i] = _mamba_block(p, x, cfg)
    return unembed(params, x[:, -1:], cfg), caches, S


def _decode_layer(p, x, cache, pos: int, cfg: ModelConfig, lc: LayerCfg):
    cd = cfg.cdtype
    if lc.kind == "attn_mlp":
        a = cfg.attn
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        positions = torch.full((1,), pos, device=x.device)
        q, k, v = attention_qkv(p["attn"], h, positions, rope_theta=a.rope_theta, qk_norm=a.qk_norm,
                                compute_dtype=cd)
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)  # slot = pos: full attention
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q, cache["k"], cache["v"], length=pos + 1)
        x = x + attention_out(p["attn"], o, cd)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, cd), cache
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    out, state = ssm_mod.mamba_decode_step(p["mamba"], h, cache, cfg.ssm, cfg.d_model, cd)
    return x + out, state


def decode_step(params, token, caches, pos: int, cfg: ModelConfig):
    """One serving step: token (B, 1) at position ``pos`` -> (logits (B, 1,
    V), caches).  KV caches are updated in place."""
    x = embed_tokens(params, token, cfg)
    new_caches = []
    for i, ref in enumerate(iter_layers(cfg)):
        x, c = _decode_layer(_layer_param_slice(params, ref), x, caches[i], pos, cfg, ref.lc)
        new_caches.append(c)
    return unembed(params, x, cfg), new_caches
