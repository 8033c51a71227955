"""Dense llama-family decoder LM: the serving path.

Counterpart of ``repro.models.dense`` for ``param_defs``, ``cache_defs``
/ ``init_cache``, ``prefill``, ``decode_step`` and ``decode_sample_step``
(no ``kv_quant``).  Layers are stacked on a leading dim as in the
reference and iterated with a Python loop.  Attention goes through
``core.offload``: the Hopper kernels on the GPU, the plain versions on
the CPU.

The KV cache is updated **in place** (``k[l].index_put_``, slice
copies), where the reference builds a new cache with ``.at[].set``; the
returned cache dict is the one passed in.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import offload
from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef
from repro_torch.serving.sampler import sample_on_device

Pytree = Any


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_defs(cfg) -> Pytree:
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.padded_vocab(), cfg.d_ff
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "blocks": {
            "ln1": ParamDef((L, D), ("layers", "embed"), "zeros"),
            "wq": ParamDef((L, D, Hq, Dh), ("layers", "embed", "heads", "head_dim")),
            "wk": ParamDef((L, D, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
            "wv": ParamDef((L, D, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
            "wo": ParamDef((L, Hq, Dh, D), ("layers", "heads", "head_dim", "embed")),
            "ln2": ParamDef((L, D), ("layers", "embed"), "zeros"),
            "w_gate": ParamDef((L, D, F), ("layers", "embed", "mlp")),
            "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp")),
            "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed")),
        },
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((V, D), ("vocab", "embed"), "embed")
    return defs


def _unembed_table(params):
    return params.get("unembed", params["embed"])


def _layer(params, l: int) -> dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["blocks"].items()}


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_seq: int) -> Pytree:
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    kv = ParamDef(
        (L, batch, max_seq, Hkv, Dh),
        ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim"),
        "zeros",
    )
    return {"k": kv, "v": kv, "lengths": ParamDef((batch,), ("kv_batch",), "zeros")}


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> Pytree:
    defs = cache_defs(cfg, batch, max_seq)
    return {
        k: torch.zeros(d.shape, dtype=dtype if k != "lengths" else torch.int32,
                       device=device)
        for k, d in defs.items()
    }


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree):
    """Fill the cache with the S context tokens ``tokens (B, S)``; return
    last-position logits ``(B, V)`` and the cache.

    K/V are written in place at positions ``[0, S)`` of ``cache``, which
    may be a view of a larger cache (the engine passes one slot's
    stripe); ``lengths`` is set to S."""
    x = cm.embed_lookup(params["embed"], tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
        k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
        v = cm.linear(h, p["wv"])
        o = offload.prefill_attention(q, k, v)
        x = x + cm.linear(o, p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        cache["k"][l, :, :S].copy_(k)
        cache["v"][l, :, :S].copy_(v)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x[:, -1], _unembed_table(params), cfg.vocab)
    cache["lengths"].fill_(S)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _append(cache_l: torch.Tensor, new: torch.Tensor, bidx: torch.Tensor,
            pos: torch.Tensor, valid: torch.Tensor) -> None:
    """Write ``new (B, Hkv, Dh)`` at ``cache_l[b, pos[b]]`` in place, for
    the rows where ``valid``.  A row at ``pos >= max_seq`` (an idle slot
    that has run past the end; JAX drops such scatter writes, CUDA would
    fault on them) rewrites what is already there, without a host sync."""
    old = cache_l[bidx, pos]
    cache_l.index_put_((bidx, pos),
                       torch.where(valid[:, None, None], new.to(cache_l.dtype), old))


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One autoregressive step.  tokens (B,) -> logits (B, V), cache.

    Every slot advances, idle ones included, as in the reference: the
    new token's K/V land at ``lengths`` (skipped where ``lengths >=
    max_seq``) and ``lengths`` grows by one, in place."""
    lengths = cache["lengths"]
    S = cache["k"].shape[2]
    B = tokens.shape[0]
    x = cm.embed_lookup(params["embed"], tokens)                # (B, D)
    pos = lengths.long()
    bidx = torch.arange(B, device=x.device)
    valid = pos < S
    wpos = pos.clamp(max=S - 1)
    attn_len = lengths + 1
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(cm.linear(h, p["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        v = cm.linear(h, p["wv"])
        k_l, v_l = cache["k"][l], cache["v"][l]
        _append(k_l, k, bidx, wpos, valid)
        _append(v_l, v, bidx, wpos, valid)
        o = offload.decode_attention(q, k_l, v_l, attn_len)
        x = x + cm.linear(o, p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, _unembed_table(params), cfg.vocab)
    lengths.add_(1)
    return logits, cache


def decode_sample_step(cfg, params, cache: Pytree, tokens: torch.Tensor,
                       generator: torch.Generator | None, eos_ids: torch.Tensor, *,
                       sampler):
    """One decode step with sampling fused: (tokens', eos_hit, cache).
    Only ``(B,)`` ids leave the device; nothing here waits on it."""
    logits, cache = decode_step(cfg, params, cache, tokens)
    tok = sample_on_device(logits, generator, sampler)
    return tok, tok == eos_ids, cache
