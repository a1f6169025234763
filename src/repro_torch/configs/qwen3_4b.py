"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, GQA.  [hf:Qwen/Qwen3-4B]

Qwen3-4B ties its input embedding and output head (about 4.0B parameters);
this config, like the JAX package's, keeps a separate ``lm_head``
(4,411,424,256 parameters) until tied embeddings are ported.
"""
from repro_torch.models.config import AttnCfg, GroupCfg, LayerCfg, ModelConfig
from repro_torch.models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        d_model=2560,
        vocab=151936,
        d_ff=9728,
        attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True, rope_theta=1e6),
        groups=(GroupCfg(name="main", repeat=36, unit=(LayerCfg("attn_mlp"),)),),
        param_dtype="float32",
        num_agents=16,
        source="hf:Qwen/Qwen3-4B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        d_model=128,
        vocab=512,
        d_ff=384,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=True, rope_theta=1e6),
        groups=(GroupCfg(name="main", repeat=2, unit=(LayerCfg("attn_mlp"),)),),
        param_dtype="float32",
        compute_dtype="float32",
        num_agents=4,
        remat=False,
    )


register("qwen3-4b", full)
register("qwen3-4b-smoke", reduced)
