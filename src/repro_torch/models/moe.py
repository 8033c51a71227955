"""MoE FFN + the moonshot-v1-16b-a3b family (GQA attention + MoE layers):
the serving and training paths.

Counterpart of ``repro.models.moe`` for ``param_defs``,
:func:`router_scores`, the dropping dispatch and combine, :func:`moe_ffn`
(one device: the reference's ``dp = 1``, no sharding), ``cache_defs`` /
``init_cache`` (the dense family's), :func:`prefill` and
:func:`decode_step`.  As in the reference the family has no chunked
prefill, paged pool, fused sampled step or speculative verify: the engine
serves it on the dense cache with the decode-only schedule, sampling
through its ``_wrap_sampled``.  Training: :func:`hidden_states` and
:func:`loss_fn` (CE plus the router's load-balance aux,
:func:`load_balance_aux`), one layer recomputed in the backward.

Router: top-k of softmax or sigmoid scores over f32 logits, renormalised.
Dispatch is the reference's dropping formulation: each (token, choice)
takes the next free row of its expert's capacity buffer in token-major
order, overflow goes to a garbage row that the combine masks, the expert
products run as batched matmuls over all experts, and the combine sums
each token's ``top_k`` weighted rows.  Every shape follows from the token
count alone, and nothing reads a device value on the host, so a decode
step captures into one CUDA graph.

Layers ``l < moe_layer_start`` take the dense SwiGLU, the rest the MoE
FFN (routed output first, shared experts added after it).  Attention and
the KV cache are the dense family's: the cache is written in place
(:func:`dense._append`, slice copies of a slot's view), where the
reference concatenates new cache arrays.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import offload
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.common import ParamDef

Pytree = Any

cache_defs = dense.cache_defs
init_cache = dense.init_cache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _attn_defs(cfg, L):
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "ln1": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "wq": ParamDef((L, D, Hq, Dh), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamDef((L, D, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ParamDef((L, D, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ParamDef((L, Hq, Dh, D), ("layers", "heads", "head_dim", "embed")),
        "ln2": ParamDef((L, D), ("layers", "embed"), "zeros"),
    }


def moe_ffn_defs(cfg, L) -> Pytree:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    defs = {
        "router": ParamDef((L, D, E), ("layers", "embed", None), "small"),
        "we_gate": ParamDef((L, E, D, Fe), ("layers", "experts", "embed", None)),
        "we_up": ParamDef((L, E, D, Fe), ("layers", "experts", "embed", None)),
        "we_down": ParamDef((L, E, Fe, D), ("layers", "experts", None, "embed")),
    }
    if m.n_shared:
        Fs = m.n_shared * Fe
        defs.update(
            ws_gate=ParamDef((L, D, Fs), ("layers", "embed", "mlp")),
            ws_up=ParamDef((L, D, Fs), ("layers", "embed", "mlp")),
            ws_down=ParamDef((L, Fs, D), ("layers", "mlp", "embed")),
        )
    return defs


def param_defs(cfg) -> Pytree:
    m = cfg.moe
    L_dense, L_moe = m.moe_layer_start, cfg.n_layers - m.moe_layer_start
    D, V, F_ = cfg.d_model, cfg.padded_vocab(), cfg.d_ff
    dense_blocks = {
        **_attn_defs(cfg, L_dense),
        "w_gate": ParamDef((L_dense, D, F_), ("layers", "embed", "mlp")),
        "w_up": ParamDef((L_dense, D, F_), ("layers", "embed", "mlp")),
        "w_down": ParamDef((L_dense, F_, D), ("layers", "mlp", "embed")),
    }
    moe_blocks = {**_attn_defs(cfg, L_moe), **moe_ffn_defs(cfg, L_moe)}
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "dense_blocks": dense_blocks,
        "moe_blocks": moe_blocks,
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((V, D), ("vocab", "embed"), "embed")
    return defs


# ---------------------------------------------------------------------------
# MoE FFN compute
# ---------------------------------------------------------------------------
def router_scores(cfg, router_w: torch.Tensor, x: torch.Tensor):
    """x (T, D) -> (weights (T, K) f32, expert ids (T, K) int64).

    ``lax.top_k``'s order: scores descending, ties to the lower expert id
    (a stable descending sort)."""
    return _top_k(cfg, _router_logits(router_w, x))


def _router_logits(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ router_w.float()


def _top_k(cfg, logits: torch.Tensor):
    m = cfg.moe
    if m.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :m.top_k], topi[:, :m.top_k]
    return topw / topw.sum(-1, keepdim=True).clamp(min=1e-9), topi


def load_balance_aux(cfg, logits: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The reference router's switch-style load-balance loss, f32 scalar:
    ``E * sum_e f_e * P_e / K`` with f_e the share of the T * K choices
    routed to expert e and P_e the mean softmax probability of e."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(topi, m.n_experts).float()             # (T, K, E)
    f = onehot.sum(dim=1).mean(dim=0)
    return m.n_experts * (f * probs.mean(dim=0)).sum() / m.top_k


def capacity(cfg, n_tokens: int) -> int:
    """Rows per expert buffer: ``max(ceil(T * K / E * cf), K)``."""
    m = cfg.moe
    return max(int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor)), m.top_k)


def dispatch(cfg, x: torch.Tensor, topi: torch.Tensor):
    """Dropping dispatch of x (T, D) by ``topi`` (T, K): the expert
    buffers ``(E, C + 1, D)`` and ``(e_flat, pos, dropped)`` per
    assignment (token-major, M = T * K).  An assignment's row is its rank
    among the earlier assignments to its expert (the reference's one-hot
    cumsum); rows at or past the capacity C are dropped to the garbage
    row C.  Every row below C receives at most one token, so a plain
    ``index_put_`` writes the reference's ``.at[].add`` exactly; the
    garbage row, where several may land, is never read back."""
    T, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(cfg, T)
    e_flat = topi.reshape(-1)
    oh = (e_flat[:, None] == torch.arange(E, device=x.device)).int()     # (M, E)
    pos = (oh.cumsum(0) * oh).sum(-1) - 1
    dropped = pos >= cap
    pos = torch.where(dropped, cap, pos)
    disp = x.new_zeros(E, cap + 1, D)
    disp[e_flat, pos] = x[:, None].expand(T, K, D).reshape(T * K, D)
    return disp, (e_flat, pos, dropped)


def combine(out_e: torch.Tensor, meta, topw: torch.Tensor) -> torch.Tensor:
    """Expert outputs ``(E, C + 1, D)`` back to tokens ``(T, D)``: each
    token's K rows (dropped ones zeroed) times their weights, summed in
    order k = 0 .. K-1 with a rounding to the output dtype after each add,
    as the reference's scatter-add does, so no atomics and no order left
    to the device."""
    e_flat, pos, dropped = meta
    T, K = topw.shape
    gathered = out_e[e_flat, pos].masked_fill(dropped[:, None], 0)
    terms = (gathered * topw.reshape(-1, 1).to(gathered.dtype)).view(T, K, -1)
    y = torch.zeros_like(terms[:, 0])
    for k in range(K):
        y = y + terms[:, k]
    return y


def moe_ffn(cfg, p, x: torch.Tensor, return_aux: bool = False):
    """x (T, D) -> (T, D).  p: one layer of :func:`moe_ffn_defs`.  All T
    tokens route as one group (the reference's ``dp = 1``), so the
    capacity is ``capacity(cfg, T)``.  ``return_aux`` (training): ``(y,
    load-balance aux)``."""
    logits = _router_logits(p["router"], x)
    topw, topi = _top_k(cfg, logits)
    disp, meta = dispatch(cfg, x, topi)
    h = F.silu(torch.bmm(disp, p["we_gate"])) * torch.bmm(disp, p["we_up"])
    y = combine(torch.bmm(h, p["we_down"]), meta, topw)
    if cfg.moe.n_shared:
        y = y + cm.swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    y = y.to(x.dtype)
    return (y, load_balance_aux(cfg, logits, topi)) if return_aux else y


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _block_train(cfg, p, x: torch.Tensor, positions: torch.Tensor, is_moe: bool):
    """One layer: ``(x', load-balance aux)``, aux 0 for a dense layer."""
    x = dense._attn(cfg, p, x, positions)[0]
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if not is_moe:
        return x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None
    y, aux = moe_ffn(cfg, p, h.reshape(-1, h.shape[-1]), return_aux=True)
    return x + y.reshape(h.shape), aux


def hidden_states(cfg, params, tokens: torch.Tensor, embeds: torch.Tensor | None = None):
    """-> (final hidden (B, S, D), mean load-balance aux over the MoE
    layers); each layer's block recomputed in the backward."""
    x, positions = dense._embed(params, tokens, embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for tree, is_moe in ((params["dense_blocks"], False), (params["moe_blocks"], True)):
        for p in cm.unstack(tree):
            x, a = cm.remat(_block_train, cfg, p, x, positions, is_moe)
            if is_moe:
                aux = aux + a
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux / max(cfg.n_layers - cfg.moe.moe_layer_start, 1)


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """``ce + router_aux_coef * aux`` -> ``(loss, {"loss", "ce", "aux"})``."""
    hid, aux = hidden_states(cfg, params, batch["inputs"], batch.get("embeds"))
    n_front = 0 if "embeds" not in batch else batch["embeds"].shape[1]
    logits = cm.unembed(hid[:, n_front:], dense._unembed_table(params), cfg.vocab)
    ce = cm.cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    loss = ce + cfg.moe.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill / decode  (attention identical to dense; FFN swapped)
# ---------------------------------------------------------------------------
def _blocks(cfg, params):
    """``(layer, weights, is_moe)`` for every layer in order: the
    ``moe_layer_start`` dense layers, then the MoE ones."""
    Ld = cfg.moe.moe_layer_start
    for l in range(cfg.n_layers):
        is_moe = l >= Ld
        tree = params["moe_blocks"] if is_moe else params["dense_blocks"]
        yield l, {k: v[l - Ld if is_moe else l] for k, v in tree.items()}, is_moe


def _ffn(cfg, p, h: torch.Tensor, is_moe: bool) -> torch.Tensor:
    if not is_moe:
        return cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return moe_ffn(cfg, p, h.reshape(-1, h.shape[-1])).reshape(h.shape)


def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None):
    """Fill the cache with ``tokens (B, S)``; last-position logits
    ``(B, V)`` and the cache, as :func:`dense.prefill` (K/V written in
    place at ``[0, S)`` of ``cache``, which may be a slot's view;
    ``embeds`` prepended, taking cache positions).  The MoE layers route
    all B * S tokens together."""
    x, positions = dense._embed(params, tokens, embeds)
    S = x.shape[1]
    for l, p, is_moe in _blocks(cfg, params):
        x, k, v = dense._attn(cfg, p, x, positions)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h, is_moe)
        cache["k"][l, :, :S].copy_(k)
        cache["v"][l, :, :S].copy_(v)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x[:, -1], dense._unembed_table(params), cfg.vocab)
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One autoregressive step, as :func:`dense.decode_step`: every slot
    advances (idle ones too, and their tokens are routed with the rest,
    as in the reference), K/V appended in place at ``lengths`` (skipped
    past ``max_seq``), ``lengths`` grows by one in place."""
    lengths = cache["lengths"]
    S = cache["k"].shape[2]
    B = tokens.shape[0]
    x = cm.embed_lookup(params["embed"], tokens)                # (B, D)
    pos = lengths.long()
    bidx = torch.arange(B, device=x.device)
    valid = pos < S
    wpos = pos.clamp(max=S - 1)
    attn_len = lengths + 1
    for l, p, is_moe in _blocks(cfg, params):
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(cm.linear(h, p["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        v = cm.linear(h, p["wv"])
        k_l, v_l = cache["k"][l], cache["v"][l]
        dense._append(k_l, k, bidx, wpos, valid)
        dense._append(v_l, v, bidx, wpos, valid)
        o = offload.decode_attention(q, k_l, v_l, attn_len)
        x = x + cm.linear(o, p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h, is_moe)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, dense._unembed_table(params), cfg.vocab)
    lengths.add_(1)
    return logits, cache
