"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm, GQA.  [hf:Qwen/Qwen3-8B]

Its smoke variant is the train CLI's default ``--arch``
(``python -m repro_torch.launch.train``).
"""
from repro_torch.models.config import AttnCfg, GroupCfg, LayerCfg, ModelConfig
from repro_torch.models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        d_model=4096,
        vocab=151936,
        d_ff=12288,
        attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True, rope_theta=1e6),
        groups=(GroupCfg(name="main", repeat=36, unit=(LayerCfg("attn_mlp"),)),),
        param_dtype="float32",
        num_agents=16,
        source="hf:Qwen/Qwen3-8B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke",
        family="dense",
        d_model=256,
        vocab=512,
        d_ff=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True, rope_theta=1e6),
        groups=(GroupCfg(name="main", repeat=2, unit=(LayerCfg("attn_mlp"),)),),
        param_dtype="float32",
        compute_dtype="float32",
        num_agents=4,
        remat=False,
    )


register("qwen3-8b", full)
register("qwen3-8b-smoke", reduced)
