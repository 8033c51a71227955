"""GPU/HPU load balancing: the paper's §IV-C napkin math.

A copy of ``repro.core.balance``.  :func:`_active_params` and
:func:`kv_bytes_per_seq` count a token's linear parameters and a
sequence's KV bytes for every family (the serving telemetry's cost model
reads them); :func:`plan` picks a KV placement policy and a sub-batch
count for a decode shape on a mesh from a device's constants, through the
same resolver the placed model uses.  A plan is the cost model's, not a
measurement; its default device is the reference's ``TPU-V5E``, so that
the serve CLI's ``balancer:`` line equals the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import RWKV6, ZAMBA2, ModelConfig, ShapeConfig
from repro_torch.core.oi import BYTES_PER_EL, DEVICES, Device
from repro_torch.core.placement import kv_rules, lanes
from repro_torch.models.common import resolve_spec


@dataclasses.dataclass(frozen=True)
class Plan:
    kv_policy: str
    sub_batches: int
    t_linear: float          # s per decode step, compute side
    t_attention: float       # s per decode step, HPU-layout side
    t_boundary: float        # s, Q/KV boundary collective
    bottleneck: str
    kv_shards: int           # chips the cache actually spans


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


def plan(cfg: ModelConfig, shape: ShapeConfig, axes: dict[str, int],
         dev: Device = DEVICES["TPU-V5E"]) -> Plan:
    """Pick the KV policy and sub-batch count of a decode shape on a mesh
    of ``axes``: the policy whose cache spans the most chips (ties go to
    batch, then batch_seq, sequence, head: paper Fig. 4 prefers batch on
    merge cost), two sub-batches when the smaller stage is over a fifth of
    the larger."""
    B, S = shape.global_batch, shape.seq_len
    n_chips = lanes(axes)

    def shards(policy: str) -> int:
        """Chips the cache spans under ``policy``, by the resolver."""
        rules = kv_rules(policy)
        if cfg.mla is not None:          # the latent cache has no head axis
            logical = ("kv_batch", "kv_seq", None)
            dims = (B, S, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
        elif cfg.family == RWKV6:        # the state cache: (B, H, N, N)
            logical = ("kv_batch", "state", None, None)
            H = cfg.d_model // cfg.rwkv.head_dim
            dims = (B, H, cfg.rwkv.head_dim, cfg.rwkv.head_dim)
        else:
            logical = ("kv_batch", "kv_seq", "kv_heads", "head_dim")
            dims = (B, S, max(cfg.n_kv_heads, 1), cfg.resolved_head_dim())
        spec = resolve_spec(logical, rules, axes, dims)
        n = 1
        for i in range(len(spec)):
            for ax in spec.axes(i):
                n *= axes[ax]
        return n

    candidates = {}
    for policy in ("batch", "head", "sequence", "batch_seq"):
        n = shards(policy)
        candidates[policy] = (kv_bytes_per_seq(cfg, S) * B / (n * dev.bw), n)
    order = {"batch": 0, "batch_seq": 1, "sequence": 2, "head": 3}
    best = min(candidates, key=lambda p: (candidates[p][0], order[p]))
    t_attn, n_shards = candidates[best]

    t_linear = 2 * _active_params(cfg) * B / (n_chips * dev.flops)
    t_linear = max(t_linear, _active_params(cfg) * BYTES_PER_EL / (n_chips * dev.bw))
    # boundary: per-token q/k/v and output vectors over the links
    Dh = cfg.resolved_head_dim()
    bound = cfg.n_layers * B * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * Dh * BYTES_PER_EL
    t_bound = bound / (n_chips * dev.net)

    sub = 2 if min(t_linear, t_attn) > 0.2 * max(t_linear, t_attn) else 1
    bottleneck = "attention" if t_attn >= t_linear else "linear"
    return Plan(best, sub, t_linear, t_attn, t_bound, bottleneck, n_shards)


def balancer_line(p: Plan) -> str:
    """The serve CLI's ``balancer:`` line, the reference's format."""
    return (f"balancer: policy={p.kv_policy} sub_batches={p.sub_batches} "
            f"bottleneck={p.bottleneck} "
            f"(t_att={p.t_attention*1e3:.2f}ms t_lin={p.t_linear*1e3:.2f}ms)")
