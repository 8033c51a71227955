"""Reduced (smoke-test scale) variants of the registered architectures:
same family and topology, tiny dims (the dense branch of
``repro.configs.reduced.reduce_config``)."""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


def reduce_config(arch: str, vocab: int = 512) -> ModelConfig:
    cfg = get_config(arch)
    return cfg.with_overrides(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=vocab,
        head_dim=16,
    )
