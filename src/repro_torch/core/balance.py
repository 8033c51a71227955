"""Per-token parameter and KV-byte counts (paper §IV-C's napkin math).

The part of ``repro.core.balance`` that the serving telemetry's cost
model reads: :func:`_active_params` and :func:`kv_bytes_per_seq`, for the
dense family (the only family the port has).  The MLA, MoE, RWKV and
Zamba branches come with those families (ROADMAP queue 1 item 7) and
raise until then.  ``plan``, which picks a KV placement policy and a
sub-batch count from a mesh, needs ``placement.kv_rules`` / ``lanes``
and ``resolve_spec`` and waits for multi-device placement (queue 1 item
9).
"""
from __future__ import annotations

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.core.oi import BYTES_PER_EL


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md queue 1 item 7")


def _active_params(cfg: ModelConfig) -> float:
    """Per-token active linear params: attention projections and the
    gated FFN per layer, plus embedding and unembedding."""
    _dense_only(cfg)
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    Dh = cfg.resolved_head_dim()
    attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh + cfg.n_heads * Dh * D
    ffn = 3 * D * F
    return L * (attn + ffn) + 2 * V * D


def kv_bytes_per_seq(cfg: ModelConfig, seq: int) -> float:
    """K and V bytes of ``seq`` positions over all layers, at
    ``BYTES_PER_EL`` (2) bytes an element whatever the cache stores."""
    _dense_only(cfg)
    return 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.resolved_head_dim() * BYTES_PER_EL
