"""Per-token parameter and KV-byte counts (paper §IV-C's napkin math).

The part of ``repro.core.balance`` that the serving telemetry's cost
model reads: :func:`_active_params` and :func:`kv_bytes_per_seq`, for the
dense, MoE and DeepSeek (MLA) families (those the port has).  The RWKV
and Zamba branches come with those families (ROADMAP queue 1 item 7) and
raise until then.  ``plan``, which picks a KV placement policy and a
sub-batch count from a mesh, needs ``placement.kv_rules`` / ``lanes``
and ``resolve_spec`` and waits for multi-device placement (queue 1 item
9).
"""
from __future__ import annotations

from repro_torch.configs.base import DEEPSEEK, DENSE, MOE, ModelConfig
from repro_torch.core.oi import BYTES_PER_EL


def _ported(cfg: ModelConfig) -> None:
    if cfg.family not in (DENSE, MOE, DEEPSEEK):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md queue 1 item 7")


def _active_params(cfg: ModelConfig) -> float:
    """Per-token active linear params: attention projections (MLA's low-rank
    ones for DeepSeek) and the gated FFN per layer (an MoE layer counts its
    top-k and shared experts only), plus embedding and unembedding."""
    _ported(cfg)
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    Dh = cfg.resolved_head_dim()
    if cfg.mla is not None:
        a = cfg.mla
        attn = D * a.q_lora_rank + a.q_lora_rank * cfg.n_heads * (
            a.qk_nope_head_dim + a.qk_rope_head_dim
        )
        attn += D * a.kv_lora_rank + D * a.qk_rope_head_dim
        attn += a.kv_lora_rank * cfg.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
        attn += cfg.n_heads * a.v_head_dim * D
    else:
        attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh + cfg.n_heads * Dh * D
    if cfg.moe is not None:
        m = cfg.moe
        ffn_moe = 3 * D * m.d_expert * (m.top_k + m.n_shared)
        Lm = L - m.moe_layer_start
        ffn = (m.moe_layer_start * 3 * D * F + Lm * ffn_moe) / L
    else:
        ffn = 3 * D * F
    return L * (attn + ffn) + 2 * V * D


def kv_bytes_per_seq(cfg: ModelConfig, seq: int) -> float:
    """K and V bytes of ``seq`` positions over all layers (MLA: the latent
    and rope key), at ``BYTES_PER_EL`` (2) bytes an element whatever the
    cache stores."""
    _ported(cfg)
    if cfg.mla is not None:
        a = cfg.mla
        return cfg.n_layers * seq * (a.kv_lora_rank + a.qk_rope_head_dim) * BYTES_PER_EL
    return 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.resolved_head_dim() * BYTES_PER_EL
