"""DeepSeek-V3: Multi-head Latent Attention (MLA) on top of the MoE FFN, with
an MTP block in the weights: the serving and training paths.

Counterpart of ``repro.models.deepseek`` for ``param_defs`` (the MTP
block included: serving never reads it), the expanded MLA of prefill and
training (:func:`_mla_train_attn`), the absorbed MLA decode over the
latent cache (:func:`_mla_decode_attn`), ``cache_defs`` / ``init_cache``,
:func:`prefill`, :func:`decode_step` and training
(:func:`hidden_states`, :func:`loss_fn`: CE, the router's load-balance
aux over the MoE layers and the MTP head's CE at weight
:data:`MTP_WEIGHT`; each layer recomputed in the backward, the MTP block
not, as in the reference).  As in the reference the family has no
chunked prefill, paged pool, fused sampled step or speculative verify:
the engine serves it on the dense cache with the decode-only schedule,
sampling through its ``_wrap_sampled``.

The cache holds only the compressed latent ``ckv (L, B, S, kv_lora_rank)``
and the rope key ``krope (L, B, S, qk_rope_head_dim)`` shared by all
heads: 576 values per position at full width, against 2 * 128 * 128 for
expanded K/V.  Prefill expands them into per-head K/V and runs the plain
chunked attention (q/k head dim 192, v 128: no flash kernel takes that);
decode absorbs W_UK into the query and W_UV / W_O into the output and
attends over the latent (``core.offload.mla_decode_attention``, plain
torch on both devices, as the reference's jnp).  The MoE FFN, its
routing and the dense/MoE layer split are ``models.moe``'s.  The cache is
written in place (slice copies in prefill, :func:`dense._append` in
decode), where the reference concatenates new cache arrays.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import offload
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import dense, moe
from repro_torch.models.common import ParamDef

Pytree = Any

MTP_WEIGHT = 0.3


def _dims(cfg):
    a = cfg.mla
    return a, a.qk_nope_head_dim + a.qk_rope_head_dim


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _mla_defs(cfg, L):
    a, d_qk = _dims(cfg)
    D, H = cfg.d_model, cfg.n_heads
    return {
        "ln1": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "w_dq": ParamDef((L, D, a.q_lora_rank), ("layers", "embed", None)),
        "q_norm": ParamDef((L, a.q_lora_rank), ("layers", None), "zeros"),
        "w_uq": ParamDef((L, a.q_lora_rank, H, d_qk), ("layers", None, "heads", "head_dim")),
        "w_dkv": ParamDef((L, D, a.kv_lora_rank), ("layers", "embed", None)),
        "kv_norm": ParamDef((L, a.kv_lora_rank), ("layers", None), "zeros"),
        "w_krope": ParamDef((L, D, a.qk_rope_head_dim), ("layers", "embed", None)),
        "w_uk": ParamDef((L, a.kv_lora_rank, H, a.qk_nope_head_dim),
                         ("layers", None, "heads", "head_dim")),
        "w_uv": ParamDef((L, a.kv_lora_rank, H, a.v_head_dim),
                         ("layers", None, "heads", "head_dim")),
        "wo": ParamDef((L, H, a.v_head_dim, D), ("layers", "heads", "head_dim", "embed")),
        "ln2": ParamDef((L, D), ("layers", "embed"), "zeros"),
    }


def _dense_ffn_defs(cfg, L):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed")),
    }


def param_defs(cfg) -> Pytree:
    Ld = cfg.moe.moe_layer_start
    D, V = cfg.d_model, cfg.padded_vocab()
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "dense_blocks": {**_mla_defs(cfg, Ld), **_dense_ffn_defs(cfg, Ld)},
        "moe_blocks": {**_mla_defs(cfg, cfg.n_layers - Ld),
                       **moe.moe_ffn_defs(cfg, cfg.n_layers - Ld)},
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "unembed": ParamDef((V, D), ("vocab", "embed"), "embed"),
    }
    if cfg.mtp_depth:
        defs["mtp"] = {
            "norm_h": ParamDef((D,), ("embed",), "zeros"),
            "norm_e": ParamDef((D,), ("embed",), "zeros"),
            "proj": ParamDef((2 * D, D), (None, "embed")),
            "block": {**_mla_defs(cfg, 1), **_dense_ffn_defs(cfg, 1)},
            "final_norm": ParamDef((D,), ("embed",), "zeros"),
        }
    return defs


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------
def _mla_train_attn(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """Expanded MLA for prefill: x (B, S, D) -> (attn_out (B, S, D),
    ckv (B, S, Dc), krope (B, S, Dr))."""
    a, d_qk = _dims(cfg)
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    cq = cm.rmsnorm(cm.linear(h, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = cm.linear(cq, p["w_uq"])                                # (B, S, H, d_qk)
    q_nope, q_rope = q[..., :a.qk_nope_head_dim], q[..., a.qk_nope_head_dim:]
    q_rope = cm.rope(q_rope, positions, cfg.rope_theta)

    ckv = cm.rmsnorm(cm.linear(h, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_nope = cm.linear(ckv, p["w_uk"])
    v = cm.linear(ckv, p["w_uv"])
    krope = cm.rope(cm.linear(h, p["w_krope"])[:, :, None, :], positions,
                    cfg.rope_theta)                             # (B, S, 1, Dr)

    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, krope.expand(*k_nope.shape[:3], a.qk_rope_head_dim)], dim=-1)
    o = attn.chunked_attention(qf, kf, v, causal=True, scale=1.0 / math.sqrt(d_qk))
    return cm.linear(o, p["wo"], n_in=2), ckv, krope[:, :, 0, :]


def _mla_decode_attn(cfg, p, x: torch.Tensor, ckv_l: torch.Tensor, kr_l: torch.Tensor,
                     pos: torch.Tensor, wpos: torch.Tensor, valid: torch.Tensor,
                     attn_len: torch.Tensor) -> torch.Tensor:
    """Absorbed MLA decode: x (B, D) -> attn_out (B, D).  The new latent
    and rope key land in ``ckv_l`` / ``kr_l`` (B, S, .) at ``wpos`` where
    ``valid``; attention runs over ``attn_len`` positions.  As in the
    reference, the latent output and W_UV, then W_O, multiply in f32 (the
    bf16 weights cast per step: exact)."""
    a, d_qk = _dims(cfg)
    bidx = torch.arange(x.shape[0], device=x.device)
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    cq = cm.rmsnorm(cm.linear(h, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = cm.linear(cq, p["w_uq"])                                # (B, H, d_qk)
    q_nope, q_rope = q[..., :a.qk_nope_head_dim], q[..., a.qk_nope_head_dim:]
    q_rope = cm.rope(q_rope[:, None], pos[:, None], cfg.rope_theta)[:, 0]

    ckv_t = cm.rmsnorm(cm.linear(h, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    krope_t = cm.rope(cm.linear(h, p["w_krope"])[:, None, None, :], pos[:, None],
                      cfg.rope_theta)[:, 0, 0]
    dense._append(ckv_l, ckv_t, bidx, wpos, valid)
    dense._append(kr_l, krope_t, bidx, wpos, valid)

    q_latent = torch.einsum("bhn,rhn->bhr", q_nope, p["w_uk"])   # absorb W_UK
    out_latent = offload.mla_decode_attention(q_latent, q_rope, ckv_l, kr_l, attn_len,
                                              scale=1.0 / math.sqrt(d_qk))
    v_out = torch.einsum("bhr,rhn->bhn", out_latent.float(), p["w_uv"].float())
    return cm.linear(v_out, p["wo"].float(), n_in=2).to(x.dtype)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def _block_train(cfg, p, x: torch.Tensor, positions: torch.Tensor, is_moe: bool):
    """One layer: ``(x', load-balance aux)``, aux None for a dense layer."""
    x = x + _mla_train_attn(cfg, p, x, positions)[0]
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if not is_moe:
        return x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None
    y, aux = moe.moe_ffn(cfg, p, h.reshape(-1, h.shape[-1]), return_aux=True)
    return x + y.reshape(h.shape), aux


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def hidden_states(cfg, params, tokens: torch.Tensor):
    """-> (final hidden (B, S, D), mean load-balance aux over the MoE
    layers, 0 when there are none); each layer's block recomputed in the
    backward."""
    x = cm.embed_lookup(params["embed"], tokens)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for tree, is_moe in ((params["dense_blocks"], False), (params["moe_blocks"], True)):
        for p in cm.unstack(tree):
            x, a = cm.remat(_block_train, cfg, p, x, positions, is_moe)
            if is_moe:
                aux = aux + a
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux / max(cfg.n_layers - cfg.moe.moe_layer_start, 1)


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """``ce + router_aux_coef * aux`` (``+ MTP_WEIGHT * mtp_ce`` with the
    MTP block) -> ``(loss, {"loss", "ce", "aux"[, "mtp_ce"]})``.  The MTP
    block predicts token t + 2 from ``[norm(h_t); norm(embed(tok_{t+1}))]``
    projected back to d_model, sharing the embedding and the output head."""
    hid, aux = hidden_states(cfg, params, batch["inputs"])
    table = params["unembed"]
    ce = cm.cross_entropy_loss(cm.unembed(hid, table, cfg.vocab), batch["targets"],
                               batch.get("mask"))
    loss = ce + cfg.moe.router_aux_coef * aux
    metrics = {"loss": loss, "ce": ce, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        mp, tgt, mask = params["mtp"], batch["targets"], batch.get("mask")
        h_in = cm.rmsnorm(hid[:, :-1], mp["norm_h"], cfg.norm_eps)
        e_in = cm.rmsnorm(cm.embed_lookup(params["embed"], tgt[:, :-1]), mp["norm_e"],
                          cfg.norm_eps)
        x = cm.linear(torch.cat([h_in, e_in], dim=-1), mp["proj"])
        positions = _positions(x)
        for p in cm.unstack(mp["block"]):
            x, _ = _block_train(cfg, p, x, positions, False)
        x = cm.rmsnorm(x, mp["final_norm"], cfg.norm_eps)
        mtp_ce = cm.cross_entropy_loss(cm.unembed(x, table, cfg.vocab), tgt[:, 1:],
                                       None if mask is None else mask[:, 1:])
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_seq: int) -> Pytree:
    a, L = cfg.mla, cfg.n_layers
    return {
        "ckv": ParamDef((L, batch, max_seq, a.kv_lora_rank),
                        ("layers", "kv_batch", "kv_seq", None), "zeros"),
        "krope": ParamDef((L, batch, max_seq, a.qk_rope_head_dim),
                          ("layers", "kv_batch", "kv_seq", None), "zeros"),
        "lengths": ParamDef((batch,), ("kv_batch",), "zeros"),
    }


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> Pytree:
    """Zeroed latent cache: ``ckv`` and ``krope`` in ``dtype``."""
    return {k: torch.zeros(d.shape, dtype=torch.int32 if k == "lengths" else dtype,
                           device=device)
            for k, d in cache_defs(cfg, batch, max_seq).items()}


def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None):
    """Fill the cache with ``tokens (B, S)``; last-position logits
    ``(B, V)`` and the cache, whose ``ckv`` / ``krope`` are written in
    place at ``[0, S)`` (``cache`` may be a slot's view).  ``embeds`` is
    accepted and ignored, as in the reference.  The MoE layers route all
    B * S tokens together."""
    x = cm.embed_lookup(params["embed"], tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for l, p, is_moe in moe._blocks(cfg, params):
        o, ckv, krope = _mla_train_attn(cfg, p, x, positions)
        x = x + o
        x = x + moe._ffn(cfg, p, cm.rmsnorm(x, p["ln2"], cfg.norm_eps), is_moe)
        cache["ckv"][l, :, :S].copy_(ckv)
        cache["krope"][l, :, :S].copy_(krope)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x[:, -1], params["unembed"], cfg.vocab)
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One autoregressive step: every slot advances (idle ones too, and
    their tokens are routed with the rest, as in the reference), the
    latent and rope key appended in place at ``lengths`` (skipped past
    ``max_seq``, where JAX drops the write), ``lengths`` grows by one in
    place."""
    lengths = cache["lengths"]
    S = cache["ckv"].shape[2]
    x = cm.embed_lookup(params["embed"], tokens)                # (B, D)
    pos = lengths.long()
    valid = pos < S
    wpos = pos.clamp(max=S - 1)
    attn_len = lengths + 1
    for l, p, is_moe in moe._blocks(cfg, params):
        x = x + _mla_decode_attn(cfg, p, x, cache["ckv"][l], cache["krope"][l], pos, wpos,
                                 valid, attn_len)
        x = x + moe._ffn(cfg, p, cm.rmsnorm(x, p["ln2"], cfg.norm_eps), is_moe)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    lengths.add_(1)
    return logits, cache
