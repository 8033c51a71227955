"""Zamba2 hybrid: a mamba2 backbone and one *shared* attention+MLP block
[arXiv:2411.15242], the serving and training paths.

Counterpart of ``repro.models.zamba2`` for ``param_defs``,
:func:`_shared_qkv` (the weight-tied q/k/v with per-slot LoRA deltas), the
shared block of prefill and training (:func:`_shared_block_train`) and
of decode, the backbone traversal, ``cache_defs`` /
``init_cache``, :func:`prefill`, :func:`decode_step` and training
(:func:`hidden_states`, :func:`loss_fn`: each mamba layer recomputed in
the backward, its scan the functional ``mamba2._ssd_scan_train``, the
shared block not recomputed, as in the reference).  As in the reference
the family has no chunked prefill, paged pool, fused sampled step or
verify step: the engine serves it on the dense cache with the
decode-only schedule.

The shared block runs after every ``shared_block_period``-th mamba layer
(its invocation slots, :func:`_slots`), on ``concat([x, x_embed])``
(2 * d_model), with heads of 2 * d_model / n_heads; its output goes back
to d_model through a per-slot projection.  Its K/V caches are ordinary
attention caches, one per slot: prefill attends through
``core.offload.prefill_attention`` (the flash kernel on CUDA) and decode
through ``core.offload.decode_attention`` (the decode kernel).  The
mamba conv and SSM states ride in the same cache; the conv state holds
the model's dtype from the start, where the reference allocates it in
bf16 and its steps return it in the activation dtype (ROADMAP §3).  The
cache is written in place; a decode write at a full cache is skipped
(:func:`dense._append`), where JAX drops it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import offload
from repro_torch.models import common as cm
from repro_torch.models import dense, mamba2
from repro_torch.models.common import ParamDef

Pytree = Any


def _slots(cfg) -> list[int]:
    """Mamba-layer indices after which the shared block runs."""
    p = cfg.hybrid.shared_block_period
    return [i for i in range(cfg.n_layers) if i % p == p - 1]


def _attn_dims(cfg):
    D2 = 2 * cfg.d_model
    H = cfg.n_heads
    return D2, H, D2 // H


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_defs(cfg) -> Pytree:
    D, V, F = cfg.d_model, cfg.padded_vocab(), cfg.d_ff
    D2, H, Dh = _attn_dims(cfg)
    n_slots = len(_slots(cfg))
    r = cfg.hybrid.lora_rank
    shared = {
        "ln1": ParamDef((D2,), ("embed",), "zeros"),
        "wq": ParamDef((D2, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((D2, H, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((D2, H, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, Dh, D2), ("heads", "head_dim", "embed")),
        "ln2": ParamDef((D2,), ("embed",), "zeros"),
        "w_gate": ParamDef((D2, F), ("embed", "mlp")),
        "w_up": ParamDef((D2, F), ("embed", "mlp")),
        "w_down": ParamDef((F, D2), ("mlp", "embed")),
        # per-slot LoRA on q/k/v + per-slot down projection to D
        "lora_a": ParamDef((n_slots, 3, D2, r), (None, None, "embed", None), "small"),
        "lora_b": ParamDef((n_slots, 3, r, H * Dh), (None, None, None, "heads"), "zeros"),
        "down": ParamDef((n_slots, D2, D), (None, "embed", None)),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "mamba": mamba2.param_defs(cfg, cfg.n_layers),
        "shared": shared,
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "unembed": ParamDef((V, D), ("vocab", "embed"), "embed"),
    }


# ---------------------------------------------------------------------------
# shared attention block
# ---------------------------------------------------------------------------
def _shared_qkv(cfg, p, slot: int, h: torch.Tensor) -> list[torch.Tensor]:
    """h (..., D2) -> q, k, v (..., H, Dh) with the slot's LoRA deltas."""
    _, H, Dh = _attn_dims(cfg)
    outs = []
    for i, w in enumerate((p["wq"], p["wk"], p["wv"])):
        delta = cm.linear(cm.linear(h, p["lora_a"][slot, i]), p["lora_b"][slot, i])
        outs.append(cm.linear(h, w) + delta.reshape(*delta.shape[:-1], H, Dh))
    return outs


def _shared_out(cfg, p, slot: int, h_in: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The block after attention: output projection, the MLP, and the
    slot's projection back to d_model."""
    h_in = h_in + cm.linear(o, p["wo"], n_in=2)
    g = cm.rmsnorm(h_in, p["ln2"], cfg.norm_eps)
    h_in = h_in + cm.swiglu(g, p["w_gate"], p["w_up"], p["w_down"])
    return cm.linear(h_in, p["down"][slot])


def _shared_block_train(cfg, p, slot: int, x: torch.Tensor, x0: torch.Tensor,
                        positions: torch.Tensor):
    """The shared block of prefill and training: x, x0 (B, S, D) ->
    (delta to x (B, S, D), k, v (B, S, H, Dh)).  Its attention goes through
    ``offload.prefill_attention`` (on the card the flash kernel, with its
    lse and the backward kernel when training)."""
    h_in = torch.cat([x, x0], dim=-1)
    q, k, v = _shared_qkv(cfg, p, slot, cm.rmsnorm(h_in, p["ln1"], cfg.norm_eps))
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    o = offload.prefill_attention(q, k, v)
    return _shared_out(cfg, p, slot, h_in, o), k, v


def _shared_block_decode(cfg, p, slot: int, x: torch.Tensor, x0: torch.Tensor,
                         k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                         wpos: torch.Tensor, valid: torch.Tensor,
                         attn_len: torch.Tensor) -> torch.Tensor:
    """x, x0 (B, D) -> delta to x (B, D); the new K/V land in the slot's
    caches (B, S, H, Dh) at ``wpos`` where ``valid``."""
    bidx = torch.arange(x.shape[0], device=x.device)
    h_in = torch.cat([x, x0], dim=-1)
    q, k, v = _shared_qkv(cfg, p, slot, cm.rmsnorm(h_in, p["ln1"], cfg.norm_eps))
    q = cm.rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = cm.rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    dense._append(k_cache, k, bidx, wpos, valid)
    dense._append(v_cache, v, bidx, wpos, valid)
    o = offload.decode_attention(q, k_cache, v_cache, attn_len)
    return _shared_out(cfg, p, slot, h_in, o)


# ---------------------------------------------------------------------------
# backbone traversal
# ---------------------------------------------------------------------------
def _segments(cfg) -> list[tuple[int, int, int | None]]:
    """[(start, end, slot or None)]: the mamba layers [start, end), then
    shared block ``slot`` (if not None) before the next segment."""
    segs, prev = [], 0
    for si, li in enumerate(_slots(cfg)):
        segs.append((prev, li + 1, si))
        prev = li + 1
    if prev < cfg.n_layers:
        segs.append((prev, cfg.n_layers, None))
    return segs


def _run_mamba(cfg, params, x: torch.Tensor, cache: Pytree, lo: int, hi: int) -> torch.Tensor:
    """Mamba layers [lo, hi) over x (B, S, D), their conv and SSM states
    read from ``cache`` and advanced there in place."""
    for l in range(lo, hi):
        p = {k: v[l] for k, v in params["mamba"].items()}
        y, conv, _ = mamba2.forward(cfg, p, x, cache["conv"][l], cache["ssm"][l], cfg.norm_eps)
        x = x + y
        cache["conv"][l].copy_(conv)
    return x


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def _mamba_train(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """One mamba layer's residual delta from zero conv and SSM states (the
    reference's ``_empty_cache``), nothing written in place."""
    s = cfg.ssm
    _, H, conv_dim, _ = mamba2.dims(cfg)
    B = x.shape[0]
    conv0 = x.new_zeros(B, s.d_conv - 1, conv_dim)
    ssm0 = torch.zeros(B, H, s.d_head, s.d_state, dtype=torch.float32, device=x.device)
    return mamba2.forward(cfg, p, x, conv0, ssm0, cfg.norm_eps, train=True)[0]


def hidden_states(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """-> final hidden (B, S, D): the mamba layers (each recomputed in the
    backward) with the shared block after every slot's layer."""
    x = x0 = cm.embed_lookup(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    mamba = cm.unstack(params["mamba"])
    for lo, hi, slot in _segments(cfg):
        for p in mamba[lo:hi]:
            x = x + cm.remat(_mamba_train, cfg, p, x)
        if slot is not None:
            x = x + _shared_block_train(cfg, params["shared"], slot, x, x0, positions)[0]
    return cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE -> ``(loss, {"loss"})``."""
    logits = cm.unembed(hidden_states(cfg, params, batch["inputs"]), params["unembed"],
                        cfg.vocab)
    loss = cm.cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_seq: int) -> Pytree:
    s = cfg.ssm
    _, H, conv_dim, _ = mamba2.dims(cfg)
    _, _, Dh = _attn_dims(cfg)
    kv = ParamDef((len(_slots(cfg)), batch, max_seq, cfg.n_kv_heads, Dh),
                  ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim"), "zeros")
    return {
        "conv": ParamDef((cfg.n_layers, batch, s.d_conv - 1, conv_dim),
                         ("layers", "kv_batch", None, "state"), "zeros"),
        "ssm": ParamDef((cfg.n_layers, batch, H, s.d_head, s.d_state),
                        ("layers", "kv_batch", "state", None, None), "zeros"),
        "k": kv,
        "v": kv,
        "lengths": ParamDef((batch,), ("kv_batch",), "zeros"),
    }


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu") -> Pytree:
    """Zeroed cache: the shared block's K/V in ``dtype``, the conv state in
    the model's dtype, the SSM state in f32."""
    dt = {"conv": cm.param_dtype(cfg), "ssm": torch.float32, "k": dtype, "v": dtype,
          "lengths": torch.int32}
    return {k: torch.zeros(d.shape, dtype=dt[k], device=device)
            for k, d in cache_defs(cfg, batch, max_seq).items()}


def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None):
    """Run ``tokens (B, S)`` at positions [0, S) from the cache's states;
    last-position logits ``(B, V)`` and the cache, the states advanced,
    the shared block's K/V written at [0, S) and ``lengths`` grown by S,
    in place.  ``embeds`` is accepted and ignored, as in the reference."""
    x = x0 = cm.embed_lookup(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lo, hi, slot in _segments(cfg):
        x = _run_mamba(cfg, params, x, cache, lo, hi)
        if slot is not None:
            delta, k, v = _shared_block_train(cfg, params["shared"], slot, x, x0, positions)
            cache["k"][slot, :, :S].copy_(k)
            cache["v"][slot, :, :S].copy_(v)
            x = x + delta
    x = cm.rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    cache["lengths"].add_(S)
    return logits, cache


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One autoregressive step: every slot advances (idle ones too, as in
    the reference), the shared block's K/V appended at ``lengths``
    (skipped past ``max_seq``), ``lengths`` grown by one in place."""
    lengths = cache["lengths"]
    S = cache["k"].shape[2]
    x = x0 = cm.embed_lookup(params["embed"], tokens)             # (B, D)
    pos = lengths.long()
    valid = pos < S
    wpos = pos.clamp(max=S - 1)
    attn_len = lengths + 1
    for lo, hi, slot in _segments(cfg):
        x = _run_mamba(cfg, params, x[:, None], cache, lo, hi)[:, 0]
        if slot is not None:
            x = x + _shared_block_decode(cfg, params["shared"], slot, x, x0, cache["k"][slot],
                                         cache["v"][slot], pos, wpos, valid, attn_len)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    lengths.add_(1)
    return logits, cache
