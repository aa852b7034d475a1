"""Registry of the port's architectures: the JAX package's ten configs,
copied field for field, one module each.

dense: ``deepseek-7b``, ``qwen3-32b``, ``granite-34b`` (MQA) and
``h2o-danube-3-4b`` (sliding window); ssm: ``mamba2-370m``; moe:
``qwen3-moe-30b-a3b`` and ``moonshot-v1-16b-a3b``; vlm:
``llava-next-mistral-7b``; audio: ``hubert-xlarge``; hybrid:
``jamba-1.5-large-398b``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .base import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def reduced_config(name: str, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU tests (the JAX package's sizes)."""
    cfg = get_config(name)
    small = dict(
        n_layers=len(cfg.layer_kinds()) * 2,  # two scan blocks
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=32 if cfg.sliding_window else None,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state or cfg.family == "hybrid" else 64,
        ssm_chunk=16,
        frontend_dim=32 if cfg.frontend_dim else 0,
        vlm_img_tokens=8 if cfg.vlm_img_tokens else 0,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
