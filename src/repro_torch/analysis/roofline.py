"""Analytic FLOPs and HBM bytes of one serving dispatch.

The part of ``repro.analysis.roofline`` the serving step timeline reads:
:func:`dispatch_flops_bytes`.  The reference's ``model_flops``,
``model_bytes``, ``roofline`` and ``recompute_cell`` read XLA cost cells
of a compiled dry run; they wait for ``hlo_cost``'s counterpart
(ROADMAP.md queue 1 item 9c).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.balance import _active_params, kv_bytes_per_seq


def dispatch_flops_bytes(
    cfg: ModelConfig,
    n_decode: int,
    kv_tokens: int,
    prefill_tokens: int = 0,
    prefill_ctx_tokens: int = 0,
    n_params: float | None = None,
) -> tuple[float, float]:
    """Analytic FLOPs and HBM bytes for ONE fused serving dispatch.

    * ``n_decode`` — decode lanes in the batch (one token each);
    * ``kv_tokens`` — total KV positions the decode lanes attend over
      (sum of per-lane context lengths);
    * ``prefill_tokens`` — real tokens in the fused prefill chunk(s);
    * ``prefill_ctx_tokens`` — total context positions the chunk's
      queries attend over (``sum_i (start + i)`` for a causal chunk at
      offset ``start``).

    FLOPs: every token (decode or prefill) streams the active linear
    params once (``2 * N_active`` per token), plus the attention term
    ``2 * 2 * L * H * Dh`` per attended position (QK^T and PV).  Bytes:
    the weight stream is read **once per dispatch** (prefill GEMMs ride
    the decode weight stream), plus per-position KV reads, per-token KV
    writes, and one activation write+read per layer.  As in the
    reference, KV bytes count 2 bytes an element on fp8/int8 pools too,
    and a speculative window's k+1 passes read the weights once.
    """
    n_active = _active_params(cfg)
    n_params = n_active if n_params is None else n_params
    Dh = cfg.resolved_head_dim()
    tokens = n_decode + prefill_tokens
    attended = kv_tokens + prefill_ctx_tokens
    flops = 2.0 * n_active * tokens
    flops += 2.0 * 2.0 * cfg.n_layers * cfg.n_heads * Dh * attended
    kv_tok = kv_bytes_per_seq(cfg, 1)
    bytes_ = 2.0 * n_params                      # bf16 weight stream, once
    bytes_ += kv_tok * attended                  # KV reads (decode + chunk)
    bytes_ += kv_tok * tokens                    # KV writes
    bytes_ += 2.0 * tokens * cfg.d_model * cfg.n_layers * 2.0
    return flops, bytes_
