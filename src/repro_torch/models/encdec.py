"""Seamless-M4T backbone: a speech encoder over stub frame embeddings and
an autoregressive text decoder, at model level.

Counterpart of ``repro.models.encdec`` for ``param_defs``, :func:`encode`,
``cache_defs`` / ``init_cache``, :func:`prefill`, :func:`decode_step`
and :func:`loss_fn`.  The speech frontend is a stub: ``embeds`` (B,
frontend_len, d_model), precomputed frame embeddings, are the encoder's
input, and :func:`prefill` raises without them, as the reference's does,
so the serving engine (which passes none) cannot serve the family; it
runs as ``prefill(params, tokens, cache, embeds=frames)`` then
``decode_step``.  Training reads them as ``batch["src_embeds"]``: the
reference's synthetic data pipeline has none, so the family trains at
model level (``training.trainer.make_train_step`` on a batch that holds
them); the train CLI fails on its batches with the reference's KeyError.
In training every encoder and decoder layer is recomputed in the
backward, and the decoder's causal self-attention takes
``ops.FlashAttentionFn`` on the card (``core.offload.prefill_attention``).

The encoder's self-attention is non-causal and the prefill's
cross-attention reads all frames: both run the plain
``attention.chunked_attention``, as the reference calls it outside
``offload`` (no Pallas kernel takes them).  The decoder's causal
self-attention prefills through ``core.offload.prefill_attention`` (the
flash kernel on CUDA); decode attends twice per layer through
``core.offload.decode_attention`` (the decode kernel): over the self
cache, and over the cross K/V that prefill wrote once for all
``frontend_len`` frames (the write-once, read-every-step case).  The
cache is written in place; a decode write at a full self cache is
skipped (:func:`dense._append`), where JAX drops it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import offload
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.attention import chunked_attention
from repro_torch.models.common import ParamDef

Pytree = Any


def _dims(cfg):
    return cfg.d_model, cfg.n_heads, cfg.resolved_head_dim()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _attn(cfg, L, prefix=""):
    D, H, Dh = _dims(cfg)
    return {
        prefix + "wq": ParamDef((L, D, H, Dh), ("layers", "embed", "heads", "head_dim")),
        prefix + "wk": ParamDef((L, D, H, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        prefix + "wv": ParamDef((L, D, H, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        prefix + "wo": ParamDef((L, H, Dh, D), ("layers", "heads", "head_dim", "embed")),
    }


def _mlp(cfg, L):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed")),
    }


def param_defs(cfg) -> Pytree:
    D, V = cfg.d_model, cfg.padded_vocab()
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    enc = {
        "ln1": ParamDef((Le, D), ("layers", "embed"), "zeros"),
        **_attn(cfg, Le),
        "ln2": ParamDef((Le, D), ("layers", "embed"), "zeros"),
        **_mlp(cfg, Le),
    }
    dec = {
        "ln1": ParamDef((Ld, D), ("layers", "embed"), "zeros"),
        **_attn(cfg, Ld),
        "lnx": ParamDef((Ld, D), ("layers", "embed"), "zeros"),
        **_attn(cfg, Ld, prefix="x_"),
        "ln2": ParamDef((Ld, D), ("layers", "embed"), "zeros"),
        **_mlp(cfg, Ld),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "enc_blocks": enc,
        "enc_norm": ParamDef((D,), ("embed",), "zeros"),
        "dec_blocks": dec,
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "unembed": ParamDef((V, D), ("vocab", "embed"), "embed"),
    }


def _blocks(params, key: str):
    stack = params[key]
    for l in range(next(iter(stack.values())).shape[0]):
        yield l, {k: v[l] for k, v in stack.items()}


def _mlp_residual(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return x + cm.swiglu(cm.rmsnorm(x, p["ln2"], cfg.norm_eps), p["w_gate"], p["w_up"],
                         p["w_down"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _enc_block(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = (cm.linear(h, p[w]) for w in ("wq", "wk", "wv"))
    o = chunked_attention(q, k, v, causal=False)
    return _mlp_residual(cfg, p, x + cm.linear(o, p["wo"], n_in=2))


def encode(cfg, params, src_embeds: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """src_embeds (B, T, D) -> encoder hidden (B, T, D); ``remat``
    (training) recomputes each layer in the backward."""
    x = src_embeds.to(cm.param_dtype(cfg))
    for p in cm.unstack(params["enc_blocks"]):
        x = cm.remat(_enc_block, cfg, p, x) if remat else _enc_block(cfg, p, x)
    return cm.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def _dec_block_train(cfg, p, x: torch.Tensor, enc_out: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """One decoder layer over x (B, S, D): causal self-attention through
    ``offload.prefill_attention``, then cross attention over ``enc_out``
    (B, T, D) through the plain non-causal ``chunked_attention``, as the
    reference calls it, then the MLP."""
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
    k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
    x = x + cm.linear(offload.prefill_attention(q, k, cm.linear(h, p["wv"])), p["wo"], n_in=2)
    h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
    xk, xv = cm.linear(enc_out, p["x_wk"]), cm.linear(enc_out, p["x_wv"])
    o = chunked_attention(cm.linear(h, p["x_wq"]), xk, xv, causal=False)
    return _mlp_residual(cfg, p, x + cm.linear(o, p["x_wo"], n_in=2))


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE of the decoder over ``batch["inputs"]`` given the
    encoded ``batch["src_embeds"]`` -> ``(loss, {"loss"})``."""
    enc_out = encode(cfg, params, batch["src_embeds"], remat=True)
    x = cm.embed_lookup(params["embed"], batch["inputs"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for p in cm.unstack(params["dec_blocks"]):
        x = cm.remat(_dec_block_train, cfg, p, x, enc_out, positions)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    loss = cm.cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_seq: int) -> Pytree:
    _, H, Dh = _dims(cfg)
    Ld, T = cfg.n_layers, cfg.frontend_len
    logical = ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim")
    kv_self = ParamDef((Ld, batch, max_seq, H, Dh), logical, "zeros")
    kv_cross = ParamDef((Ld, batch, T, H, Dh), logical, "zeros")
    return {"k": kv_self, "v": kv_self, "xk": kv_cross, "xv": kv_cross,
            "lengths": ParamDef((batch,), ("kv_batch",), "zeros")}


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> Pytree:
    """Zeroed self and cross K/V caches in ``dtype``."""
    return {k: torch.zeros(d.shape, dtype=torch.int32 if k == "lengths" else dtype,
                           device=device)
            for k, d in cache_defs(cfg, batch, max_seq).items()}


def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None):
    """``embeds``: the source frames (B, T, D), T = ``frontend_len``.
    Encodes them, writes each decoder layer's cross K/V, prefills the
    decoder over ``tokens (B, S)`` (self K/V written at [0, S)) and sets
    ``lengths`` to S, in place; returns the last position's logits
    ``(B, V)`` and the cache.  Without ``embeds`` it raises the
    reference's AssertionError."""
    if embeds is None:
        raise AssertionError("encdec prefill needs src_embeds")
    enc_out = encode(cfg, params, embeds)
    x = cm.embed_lookup(params["embed"], tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for l, p in _blocks(params, "dec_blocks"):
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
        k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
        v = cm.linear(h, p["wv"])
        x = x + cm.linear(offload.prefill_attention(q, k, v), p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
        xk, xv = cm.linear(enc_out, p["x_wk"]), cm.linear(enc_out, p["x_wv"])
        o = chunked_attention(cm.linear(h, p["x_wq"]), xk, xv, causal=False)
        x = _mlp_residual(cfg, p, x + cm.linear(o, p["x_wo"], n_in=2))
        cache["k"][l, :, :S].copy_(k)
        cache["v"][l, :, :S].copy_(v)
        cache["xk"][l].copy_(xk)
        cache["xv"][l].copy_(xv)
    x = cm.rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One autoregressive step of every row: self-attention over the self
    cache (the new K/V appended at ``lengths``, skipped past ``max_seq``),
    cross-attention over all T cached frames; ``lengths`` grows by one in
    place."""
    lengths = cache["lengths"]
    S, T = cache["k"].shape[2], cache["xk"].shape[2]
    B = tokens.shape[0]
    x = cm.embed_lookup(params["embed"], tokens)                   # (B, D)
    pos = lengths.long()
    bidx = torch.arange(B, device=x.device)
    valid = pos < S
    wpos = pos.clamp(max=S - 1)
    attn_len = lengths + 1
    cross_len = torch.full((B,), T, dtype=torch.int32, device=x.device)
    for l, p in _blocks(params, "dec_blocks"):
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(cm.linear(h, p["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k_l, v_l = cache["k"][l], cache["v"][l]
        dense._append(k_l, k, bidx, wpos, valid)
        dense._append(v_l, cm.linear(h, p["wv"]), bidx, wpos, valid)
        x = x + cm.linear(offload.decode_attention(q, k_l, v_l, attn_len), p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
        o = offload.decode_attention(cm.linear(h, p["x_wq"]), cache["xk"][l], cache["xv"][l],
                                     cross_len)
        x = _mlp_residual(cfg, p, x + cm.linear(o, p["x_wo"], n_in=2))
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    lengths.add_(1)
    return logits, cache
