"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16, mamba-1 architecture.  [arXiv:2410.05355]

Attention-free: O(1) decode state per layer.  d_inner = 2 * d_model = 8192.
"""
from repro_torch.models.config import GroupCfg, LayerCfg, ModelConfig, SSMCfg
from repro_torch.models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        d_model=4096,
        vocab=65024,
        d_ff=0,
        attn=None,
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
        groups=(GroupCfg(name="main", repeat=64, unit=(LayerCfg("mamba"),)),),
        param_dtype="float32",
        source="arXiv:2410.05355",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        d_model=128,
        vocab=512,
        d_ff=0,
        attn=None,
        ssm=SSMCfg(d_state=8, d_conv=4, expand=2),
        groups=(GroupCfg(name="main", repeat=2, unit=(LayerCfg("mamba"),)),),
        param_dtype="float32",
        compute_dtype="float32",
    )


register("falcon-mamba-7b", full)
register("falcon-mamba-7b-smoke", reduced)
