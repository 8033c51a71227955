"""RWKV6 "Finch": an attention-free RNN with data-dependent decay
[arXiv:2404.05892], the serving and training paths.

Counterpart of ``repro.models.rwkv6`` for ``param_defs``, the time-mix
pieces (:func:`_ddlerp`, :func:`_decay`, :func:`_wkv_scan`,
:func:`_time_mix`), :func:`_channel_mix`, the blocks, ``cache_defs`` /
``init_cache``, :func:`prefill`, :func:`decode_step` and training
(:func:`hidden_states`, :func:`loss_fn`).  As in the reference the
family has no chunked prefill, paged pool, fused sampled step or verify
step: the engine serves it on the dense state cache with the decode-only
schedule.

There is no attention and no KV cache: per layer an (H, N, N) f32 WKV
state and the last token of the previous segment for each of the two
token shifts, O(1) in the sequence length.  The WKV recurrence runs one
time step at a time in f32, as the reference's scan does: serving
advances the state in place (:func:`_wkv_scan`), training runs the
functional form :func:`_wkv_scan_train` from zero states, with the
reference's time-chunked remat.  The shift leaves hold the model's
dtype from the start, where the reference's ``init_cache`` allocates
them in bf16 and its steps return them in the activation dtype (ROADMAP
§3).  The cache is written in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef

Pytree = Any

N_MIX = 5  # w, k, v, r, g
GROUP_NORM_EPS = 64e-5
SCAN_CHUNK = 64  # prompt steps whose states one history buffer holds


def _dims(cfg):
    N = cfg.rwkv.head_dim
    return cfg.d_model // N, N


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_defs(cfg) -> Pytree:
    L, D, V, F_ = cfg.n_layers, cfg.d_model, cfg.padded_vocab(), cfg.d_ff
    H, N = _dims(cfg)
    r = cfg.rwkv
    blocks = {
        "ln1_s": ParamDef((L, D), ("layers", "embed"), "ones"),
        "ln1_b": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "ln2_s": ParamDef((L, D), ("layers", "embed"), "ones"),
        "ln2_b": ParamDef((L, D), ("layers", "embed"), "zeros"),
        # time-mix ddlerp
        "mu_x": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "mu_5": ParamDef((L, N_MIX, D), ("layers", None, "embed"), "zeros"),
        "tm_a": ParamDef((L, D, N_MIX * r.mix_lora), ("layers", "embed", None), "small"),
        "tm_b": ParamDef((L, N_MIX, r.mix_lora, D), ("layers", None, None, "embed"), "small"),
        # data-dependent decay
        "w0": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "w1": ParamDef((L, D, r.decay_lora), ("layers", "embed", None), "small"),
        "w2": ParamDef((L, r.decay_lora, D), ("layers", None, "embed"), "small"),
        # projections
        "wr": ParamDef((L, D, D), ("layers", "embed", "heads")),
        "wk": ParamDef((L, D, D), ("layers", "embed", "heads")),
        "wv": ParamDef((L, D, D), ("layers", "embed", "heads")),
        "wg": ParamDef((L, D, D), ("layers", "embed", "heads")),
        "wo": ParamDef((L, D, D), ("layers", "heads", "embed")),
        "u": ParamDef((L, H, N), ("layers", "heads", None), "small"),
        "ln_x_s": ParamDef((L, D), ("layers", "embed"), "ones"),
        "ln_x_b": ParamDef((L, D), ("layers", "embed"), "zeros"),
        # channel-mix
        "mu_ck": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "mu_cr": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "cm_k": ParamDef((L, D, F_), ("layers", "embed", "mlp")),
        "cm_v": ParamDef((L, F_, D), ("layers", "mlp", "embed")),
        "cm_r": ParamDef((L, D, D), ("layers", "embed", "heads")),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed"),
        "ln0_s": ParamDef((D,), ("embed",), "ones"),
        "ln0_b": ParamDef((D,), ("embed",), "zeros"),
        "blocks": blocks,
        "final_norm_s": ParamDef((D,), ("embed",), "ones"),
        "final_norm_b": ParamDef((D,), ("embed",), "zeros"),
        "unembed": ParamDef((V, D), ("vocab", "embed"), "embed"),
    }


# ---------------------------------------------------------------------------
# time-mix pieces
# ---------------------------------------------------------------------------
def _ddlerp(p, x: torch.Tensor, xx: torch.Tensor) -> list[torch.Tensor]:
    """5-way data-dependent interpolation.  x, xx: (..., D) -> 5 x (..., D)."""
    sx = xx - x
    base = x + sx * p["mu_x"].to(x.dtype)
    z = torch.tanh(cm.linear(base, p["tm_a"]))
    z = z.reshape(*z.shape[:-1], N_MIX, p["tm_b"].shape[1])
    off = torch.einsum("...mr,mrd->...md", z, p["tm_b"])           # (..., 5, D)
    mixed = x[..., None, :] + sx[..., None, :] * (p["mu_5"].to(x.dtype) + off)
    return list(mixed.unbind(-2))


def _decay(p, x_w: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1), f32."""
    lo = x_w.float() @ p["w1"].float()
    ww = p["w0"].float() + torch.tanh(lo) @ p["w2"].float()
    return torch.exp(-torch.exp(ww - 0.5))      # -0.5 centres the init decay ~ exp(-0.6)


def _wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, state: torch.Tensor):
    """WKV recurrence.  r, k, v, w: (B, S, H, N) f32; u (H, N); state
    (B, H, N, N) f32, ``S[h, i (k index), j (v index)]``, advanced in
    place.  Returns y (B, S, H, N) and the state.

    ``y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)`` is computed as
    ``r_t S_{t-1} + (r_t . u k_t) v_t``, the bonus term for all steps at
    once, and ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` one step at a time in
    f32.  A decode step (S 1) updates the state in place.  Over a prompt,
    each chunk of ``SCAN_CHUNK`` steps forms its outer products at once and
    writes every step's state into a history buffer, one launch a step;
    the read-outs of the chunk then run as one batched product."""
    B, S, H, N = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v                  # (B, S, H, N)
    if S == 1:
        y = (r[:, 0, :, None, :] @ state)[:, None, :, 0]           # (B, 1, H, N)
        state.mul_(w[:, 0, :, :, None]).addcmul_(k[:, 0, :, :, None], v[:, 0, :, None, :])
        return y + bonus, state
    r, k, v, w = (t.transpose(0, 1) for t in (r, k, v, w))         # (S, B, H, N)
    ys = []
    for c0 in range(0, S, SCAN_CHUNK):
        c = slice(c0, c0 + SCAN_CHUNK)
        kv = k[c, ..., None] * v[c, ..., None, :]                  # (C, B, H, N, N)
        hist = torch.empty((kv.shape[0] + 1, *state.shape), dtype=state.dtype,
                           device=state.device)
        hist[0] = state
        for a, prev, wt, nxt in zip(kv.unbind(0), hist.unbind(0), w[c, ..., None].unbind(0),
                                    hist[1:].unbind(0)):
            torch.addcmul(a, prev, wt, out=nxt)
        ys.append(torch.einsum("cbhi,cbhij->cbhj", r[c], hist[:-1]))
        state.copy_(hist[-1])
    return torch.cat(ys).transpose(0, 1) + bonus, state


def _wkv_steps(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor):
    """Functional WKV steps over time-major r, k, v, w (C, B, H, N) from
    ``state``: ``(r_t S_{t-1}`` for each step (C, B, H, N), the last
    state)``.  Nothing is written in place, so autograd can take it: each
    step is one ``addcmul``; the outer products and the read-outs are one
    batched product each."""
    prev = []
    for a, wt in zip((k[..., None] * v[..., None, :]).unbind(0), w[..., None].unbind(0)):
        prev.append(state)
        state = torch.addcmul(a, state, wt)
    return torch.einsum("cbhi,cbhij->cbhj", r, torch.stack(prev)), state


def _wkv_scan_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor, chunk: int = cm.SCAN_REMAT_CHUNK):
    """The WKV recurrence of :func:`_wkv_scan` in a functional form for
    training: the same shapes, ``state`` (B, H, N, N) f32 read and not
    written; returns y (B, S, H, N) and the final state, with the
    reference's remat over time (:func:`common.scan_in_chunks`)."""
    bonus = (r * u * k).sum(-1, keepdim=True) * v                  # (B, S, H, N)
    y, state = cm.scan_in_chunks(_wkv_steps, state,
                                 [t.transpose(0, 1) for t in (r, k, v, w)], chunk)
    return y.transpose(0, 1) + bonus, state


def _group_norm(cfg, p, y: torch.Tensor) -> torch.Tensor:
    """Per-head norm of the WKV output (B, S, H, N) f32 -> (B, S, D) f32:
    the population variance (``jnp.var``), eps 64e-5, then the f32 scale
    and bias."""
    B, S = y.shape[:2]
    var, mu = torch.var_mean(y, dim=-1, keepdim=True, correction=0)
    y = ((y - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, cfg.d_model)
    return y * p["ln_x_s"].float() + p["ln_x_b"].float()


def _shifted(x: torch.Tensor, shift_in: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) shifted one step right, ``shift_in (B, D)`` first."""
    return torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _time_mix(cfg, p, x: torch.Tensor, shift_in: torch.Tensor, state: torch.Tensor,
              train: bool = False):
    """x (B, S, D); shift_in (B, D); state (B, H, N, N) f32, advanced in
    place (``train``: read only, through :func:`_wkv_scan_train`).
    Returns (out (B, S, D), new shift (B, D), the new state)."""
    H, N = _dims(cfg)
    B, S, _ = x.shape
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, _shifted(x, shift_in))
    r = cm.linear(x_r, p["wr"]).reshape(B, S, H, N)
    k = cm.linear(x_k, p["wk"]).reshape(B, S, H, N)
    v = cm.linear(x_v, p["wv"]).reshape(B, S, H, N)
    g = F.silu(cm.linear(x_g, p["wg"]))
    w = _decay(p, x_w).reshape(B, S, H, N)
    scan = _wkv_scan_train if train else _wkv_scan
    y, state = scan(r.float(), k.float(), v.float(), w, p["u"].float(), state)
    y = _group_norm(cfg, p, y)
    return cm.linear(y.to(x.dtype) * g, p["wo"]), x[:, -1], state


def _channel_mix(cfg, p, x: torch.Tensor, shift_in: torch.Tensor):
    xx = _shifted(x, shift_in)
    x_k = x + (xx - x) * p["mu_ck"].to(x.dtype)
    x_r = x + (xx - x) * p["mu_cr"].to(x.dtype)
    k = torch.square(torch.relu(cm.linear(x_k, p["cm_k"])))
    v = cm.linear(k, p["cm_v"])
    r = torch.sigmoid(cm.linear(x_r, p["cm_r"]))
    return r * v, x[:, -1]


def _run_blocks(cfg, params, x: torch.Tensor, cache: Pytree) -> torch.Tensor:
    """The blocks over x (B, S, D), each reading its shifts and state from
    ``cache`` and writing the new ones there in place."""
    for l in range(cfg.n_layers):
        p = {k: v[l] for k, v in params["blocks"].items()}
        h = cm.layernorm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        o, tm, _ = _time_mix(cfg, p, h, cache["tm_shift"][l], cache["state"][l])
        x = x + o
        h = cm.layernorm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
        o, cmx = _channel_mix(cfg, p, h, cache["cm_shift"][l])
        x = x + o
        cache["tm_shift"][l].copy_(tm)
        cache["cm_shift"][l].copy_(cmx)
    return x


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def _block_train(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """One layer over x (B, S, D) from zero shifts and a zero state (the
    reference's ``_block`` under ``_run_blocks`` with no cache), nothing
    written in place."""
    H, N = _dims(cfg)
    B = x.shape[0]
    shift0 = x.new_zeros(B, cfg.d_model)
    state0 = torch.zeros(B, H, N, N, dtype=torch.float32, device=x.device)
    h = cm.layernorm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    x = x + _time_mix(cfg, p, h, shift0, state0, train=True)[0]
    h = cm.layernorm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
    return x + _channel_mix(cfg, p, h, shift0)[0]


def hidden_states(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """-> final hidden (B, S, D); each layer recomputed in the backward."""
    x = cm.embed_lookup(params["embed"], tokens)
    x = cm.layernorm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
    for p in cm.unstack(params["blocks"]):
        x = cm.remat(_block_train, cfg, p, x)
    return cm.layernorm(x, params["final_norm_s"], params["final_norm_b"], cfg.norm_eps)


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE -> ``(loss, {"loss"})``."""
    logits = cm.unembed(hidden_states(cfg, params, batch["inputs"]), params["unembed"],
                        cfg.vocab)
    loss = cm.cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_seq: int = 0) -> Pytree:
    """``max_seq`` is irrelevant for an RNN: the state is O(1) in the
    sequence length."""
    L, D = cfg.n_layers, cfg.d_model
    H, N = _dims(cfg)
    return {
        "tm_shift": ParamDef((L, batch, D), ("layers", "kv_batch", "embed"), "zeros"),
        "cm_shift": ParamDef((L, batch, D), ("layers", "kv_batch", "embed"), "zeros"),
        "state": ParamDef((L, batch, H, N, N), ("layers", "kv_batch", "state", None, None),
                          "zeros"),
        "lengths": ParamDef((batch,), ("kv_batch",), "zeros"),
    }


def init_cache(cfg, batch: int, max_seq: int = 0,
               device: torch.device | str = "cpu") -> Pytree:
    """Zeroed state cache: the shifts in the model's dtype, the WKV state
    in f32."""
    dt = {"tm_shift": cm.param_dtype(cfg), "cm_shift": cm.param_dtype(cfg),
          "state": torch.float32, "lengths": torch.int32}
    return {k: torch.zeros(d.shape, dtype=dt[k], device=device)
            for k, d in cache_defs(cfg, batch, max_seq).items()}


def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None):
    """Run ``tokens (B, S)`` from the cache's state; last-position logits
    ``(B, V)`` and the cache, its state and shifts advanced and
    ``lengths`` grown by S in place.  ``embeds`` is accepted and ignored,
    as in the reference."""
    x = cm.embed_lookup(params["embed"], tokens)
    x = cm.layernorm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
    x = _run_blocks(cfg, params, x, cache)
    x = cm.layernorm(x[:, -1], params["final_norm_s"], params["final_norm_b"], cfg.norm_eps)
    logits = cm.unembed(x, params["unembed"], cfg.vocab)
    cache["lengths"].add_(tokens.shape[1])
    return logits, cache


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor):
    """One step: a one-token prefill of ``tokens (B,)`` for every slot."""
    return prefill(cfg, params, tokens[:, None], cache)
