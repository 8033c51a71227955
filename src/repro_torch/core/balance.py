"""Per-token parameter and KV-byte counts (paper §IV-C's napkin math).

The part of ``repro.core.balance`` that the serving telemetry's cost
model reads: :func:`_active_params` and :func:`kv_bytes_per_seq`, for
every family.  ``plan``, which picks a KV placement policy and a
sub-batch count from a mesh, needs ``placement.kv_rules`` / ``lanes``
and ``resolve_spec`` and waits for multi-device placement (ROADMAP queue
1 item 9).
"""
from __future__ import annotations

from repro_torch.configs.base import RWKV6, ZAMBA2, ModelConfig
from repro_torch.core.oi import BYTES_PER_EL


def _active_params(cfg: ModelConfig) -> float:
    """Per-token active linear params: attention projections (MLA's low-rank
    ones for DeepSeek) and the gated FFN per layer (an MoE layer counts its
    top-k and shared experts only), plus embedding and unembedding.  The
    reference's formula for every family: the recurrent ones are counted
    as if they had attention of their configured heads."""
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
    cache stores.  RWKV6: the whole f32 WKV state and the two shifts, and
    Zamba2: the shared block's K/V at ``seq`` positions plus the whole f32
    SSM state, whatever ``seq`` is, as the reference counts them (so a
    cost model that multiplies the bytes of one position by the positions
    attended counts the state once per position)."""
    if cfg.family == RWKV6:
        H = cfg.d_model // cfg.rwkv.head_dim
        return cfg.n_layers * (H * cfg.rwkv.head_dim**2 * 4 + 2 * cfg.d_model * BYTES_PER_EL)
    if cfg.family == ZAMBA2:
        n_slots = max(cfg.n_layers // cfg.hybrid.shared_block_period, 1)
        attn = (2 * n_slots * seq * cfg.n_kv_heads * (2 * cfg.d_model // cfg.n_heads)
                * BYTES_PER_EL)
        d_inner = cfg.ssm.expand * cfg.d_model
        ssm = cfg.n_layers * (d_inner // cfg.ssm.d_head) * cfg.ssm.d_head * cfg.ssm.d_state * 4
        return attn + ssm
    if cfg.mla is not None:
        a = cfg.mla
        return cfg.n_layers * seq * (a.kv_lora_rank + a.qk_rope_head_dim) * BYTES_PER_EL
    return 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.resolved_head_dim() * BYTES_PER_EL
