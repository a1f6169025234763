"""Model configuration schema of the LM zoo (a copy of the reference's).

A model is a sequence of *groups*; each group repeats a *unit* of one or
more sub-layers, and its parameters are stacked along a leading repeat axis
(the reference scans over it; the port loops over it).  ``pdtype`` and
``cdtype`` are torch dtypes here.  The schema holds what the ported
families need, the ``dense`` (``attn_mlp`` layers) and the ``ssm``
(``mamba`` layers); the reference's MoE, encoder and vision fields, tied
embeddings, and its training fields (remat, agents, expert axis), come with
the slices that run them (ROADMAP.md, Queue 1 #12).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # None -> ceil(d_model / 16)

    def resolve_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    kind: Literal["attn_mlp", "moe", "mamba", "hymba"] = "attn_mlp"
    window: int | None = None  # sliding-window size; None = full attention


@dataclasses.dataclass(frozen=True)
class GroupCfg:
    name: str  # parameter key will be f"{name}_blocks"
    repeat: int  # length of the stacked repeat axis
    unit: tuple[LayerCfg, ...] = (LayerCfg(),)

    @property
    def n_layers(self) -> int:
        return self.repeat * len(self.unit)

    @property
    def param_key(self) -> str:
        return f"{self.name}_blocks"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    d_model: int
    vocab: int
    d_ff: int
    groups: tuple[GroupCfg, ...]
    attn: AttnCfg | None = None
    ssm: SSMCfg | None = None
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    source: str = ""  # the published configuration

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, v = self.d_model, self.vocab
        n = 2 * v * d + d  # embed, lm_head, final norm
        for g in self.groups:
            n += g.repeat * sum(self._layer_params(lc) for lc in g.unit)
        return n

    def _layer_params(self, lc: LayerCfg) -> int:
        d = self.d_model
        if lc.kind == "attn_mlp":
            a = self.attn
            return (
                2 * d  # ln1, ln2
                + d * a.n_heads * a.head_dim * 2  # wq, wo
                + d * a.n_kv_heads * a.head_dim * 2  # wk, wv
                + (2 * a.head_dim if a.qk_norm else 0)
                + 3 * d * self.d_ff  # gated MLP
            )
        if lc.kind == "mamba":
            s = self.ssm
            di = s.expand * d
            dtr = s.resolve_dt_rank(d)
            return (
                d  # ln
                + d * 2 * di  # in_proj
                + s.d_conv * di  # conv_w
                + di  # conv_b
                + di * (dtr + 2 * s.d_state)  # x_proj
                + dtr * di  # dt_proj
                + di  # dt_bias
                + di * s.d_state  # A_log
                + di  # D
                + di * d  # out_proj
            )
        raise NotImplementedError(f"layer kind {lc.kind!r} is not ported yet (ROADMAP.md, Queue 1 #12)")
