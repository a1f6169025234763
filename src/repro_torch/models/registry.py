"""Architecture registry: name -> ModelBundle of plain functions.

The bundle is the integration surface the serving entry point
(``repro_torch.launch.serve``) uses.  The ``dense`` and ``ssm`` families
(layer kinds ``attn_mlp`` and ``mamba``, full attention) run in the port;
the other families, and sliding-window layers, raise
``NotImplementedError`` naming ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable  # (torch.Generator) -> params on the generator's device
    forward: Callable  # (params, batch) -> logits (B, S, V)
    prefill: Callable  # (params, batch, max_len) -> (logits (B, 1, V), caches, pos)
    decode_step: Callable  # (params, token, caches, pos) -> (logits, caches)


def build_bundle(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the port runs "
            f"{PORTED_FAMILIES} (ROADMAP.md, Queue 1 #12)"
        )
    tf.check_ported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=partial(tf.init_decoder_params, cfg=cfg),
        forward=lambda params, batch: tf.forward(params, batch["tokens"], cfg),
        prefill=lambda params, batch, max_len: tf.prefill(params, batch["tokens"], cfg, max_len),
        decode_step=partial(tf.decode_step, cfg=cfg),
    )


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, cfg_fn: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = cfg_fn


def get_config(name: str) -> ModelConfig:
    _ensure_configs_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_bundle(name: str) -> ModelBundle:
    return build_bundle(get_config(name))


def list_archs() -> list[str]:
    _ensure_configs_loaded()
    return sorted(_REGISTRY)


def _ensure_configs_loaded() -> None:
    import repro_torch.configs  # noqa: F401  (registers the ported archs on import)
