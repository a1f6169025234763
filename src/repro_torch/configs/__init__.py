"""Experiment and model configurations.  Importing this package registers
the ported LM architectures (full and reduced smoke variants) in
``repro_torch.models.registry``."""
from repro_torch.configs import falcon_mamba_7b, qwen3_4b  # noqa: F401
