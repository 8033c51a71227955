"""Reduced (smoke-test scale) variants of every registered architecture:
same family and topology, tiny dims (``repro.configs.reduced.reduce_config``
branch for branch)."""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import (HybridConfig, MLAConfig, ModelConfig, MoEConfig,
                                      RWKVConfig, SSMConfig)


def reduce_config(arch: str, vocab: int = 512) -> ModelConfig:
    cfg = get_config(arch)
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=vocab,
        head_dim=16,
        frontend_len=8 if cfg.frontend != "none" else 0,
    )
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8,
            top_k=2,
            n_shared=cfg.moe.n_shared and 1,
            d_expert=32,
            score_func=cfg.moe.score_func,
            moe_layer_start=1,
            capacity_factor=2.0,
        )
        kw["n_layers"] = 3
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=48, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8)
        kw["n_kv_heads"] = 4
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_head=8, n_groups=1, d_conv=4, chunk=8, expand=2)
        kw["n_kv_heads"] = 4
        kw["n_layers"] = 5
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(shared_block_period=2, lora_rank=4)
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return cfg.with_overrides(**kw)
