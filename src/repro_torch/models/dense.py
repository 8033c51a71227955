"""Dense llama-family decoder LM: the serving and training paths.

Counterpart of ``repro.models.dense`` for ``param_defs``, ``cache_defs``
/ ``init_cache``, ``prefill``, ``decode_step``, ``decode_sample_step``,
the paged pool (``paged_cache_defs`` / ``init_paged_cache``,
``paged_decode_step``, ``paged_decode_sample_step``) with its tiered-KV
leaves (fp8/int8 pools with f32 scale pools, the host tier) and chunked
prefill (``prefill_step``, ``prefill_sample_step``) and speculation's
``verify_step`` / ``paged_verify_step``, training's ``hidden_states``
/ ``loss_fn`` (one block per layer recomputed in the backward), and the
dense cache's int8 ``kv_quant`` form (int8 K/V with bf16 scales,
dequantized before the decode kernel; prefill attends over the
unquantized K/V; chunked prefill and verify refuse it, as in the
reference).  ``prefill`` takes
a stub frontend's ``embeds``, which take cache positions.  Layers are
stacked on a leading dim as in the reference and iterated with a Python
loop.  Attention goes through
``core.offload``: the Hopper kernels on the GPU, the plain versions on
the CPU.  On a mesh (a ``core.offload.Placement`` bound in by the
registry) ``prefill`` (with ``embeds``), ``decode_step``,
``decode_sample_step``, the chunked ``prefill_step`` /
``prefill_sample_step``, the paged pool's steps (the host tier included)
and the verify steps run tensor parallel over a ``ShardedCache`` (also
the ``kv_quant`` one) or a ``ShardedPool`` (the section at the end).

The KV cache is updated **in place** (``k[l].index_put_``, slice
copies), where the reference builds a new cache with ``.at[].set``; the
returned cache dict is the one passed in.  Where the reference leans on
JAX's clamped gathers and dropped out-of-range scatters, the port clamps
or skips on the host or with masks, never with a host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import offload
from repro_torch.core.offload import Placement, ShardedCache, ShardedPool
from repro_torch.distributed import collectives
from repro_torch.kernels import ref
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
    defs = {"k": kv, "v": kv, "lengths": ParamDef((batch,), ("kv_batch",), "zeros")}
    if cfg.kv_quant:
        sc = ParamDef((L, batch, max_seq, Hkv),
                      ("layers", "kv_batch", "kv_seq", "kv_heads"), "zeros")
        defs["k_scale"] = sc
        defs["v_scale"] = sc
    return defs


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cpu", *, place: Placement | None = None,
               staging: bool = False) -> Pytree:
    """Zeroed dense cache: ``k``/``v`` in ``dtype``, or with ``kv_quant``
    int8 with bf16 ``k_scale``/``v_scale`` (whatever ``dtype``, as in the
    reference).  On a mesh (``place``) a :class:`ShardedCache` of this
    rank's shards in the KV policy's layout, allocated at their shape; with
    ``staging`` (the paged engine's staging lanes and its decode-only
    admission's prompt cache) in the compute layout instead: every row and
    position, the KV heads of this rank's tensor-parallel heads, so that a
    chunk writes and reads it with no collective and a finished block
    leaves it for the pool (``serving.paged.device.write_prompt_block``).
    One device has one layout: ``staging`` changes nothing there.  The
    ``kv_quant`` cache's scales take the reference's logical axes, so a
    rank holds the scales of the K/V it holds."""
    defs = cache_defs(cfg, batch, max_seq)
    if cfg.kv_quant:
        dt = {"k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16,
              "v_scale": torch.bfloat16}
    else:
        dt = {"k": dtype, "v": dtype}
    if place is not None and staging:
        tp = tensor_parallel(place.specs)
        h0, h1 = place.part(tp.heads, cfg.n_kv_heads)
        return ShardedCache({k: torch.zeros((batch,) if k == "lengths" else
                                            (*d.shape[:3], h1 - h0, *d.shape[4:]),
                                            dtype=dt.get(k, torch.int32), device=device)
                             for k, d in defs.items()},
                            batch=batch, max_seq=max_seq, n_kv=cfg.n_kv_heads, rows=(0, batch),
                            seq=(0, max_seq), heads=(h0, h1), head_axes=tp.heads,
                            place=place)
    if place is not None:
        specs = {k: place.env.kv_spec(d.logical, d.shape) for k, d in defs.items()}
        sp = specs["k"]
        parts = [place.part(sp.axes(i), n) for i, n in enumerate(defs["k"].shape)]
        return ShardedCache({k: torch.zeros(place.local_shape(specs[k], d.shape),
                                            dtype=dt.get(k, torch.int32), device=device)
                             for k, d in defs.items()},
                            batch=batch, max_seq=max_seq, n_kv=cfg.n_kv_heads, rows=parts[1],
                            seq=parts[2], heads=parts[3], row_axes=sp.axes(1),
                            seq_axes=sp.axes(2), head_axes=sp.axes(3), place=place)
    return {k: torch.zeros(d.shape, dtype=dt.get(k, torch.int32), device=device)
            for k, d in defs.items()}


# ---------------------------------------------------------------------------
# int8 KV quantization of the dense cache (``cfg.kv_quant``: 2x cache
# capacity, the paper's scalability axis §VI-B).  Not ``ref.kv_quantize``:
# this one has bf16 scales, a 1e-8 floor and no zero-scale case.
# ---------------------------------------------------------------------------
def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., Dh) -> (int8 payload (..., Dh), bf16 scale (...)).  The
    scale is ``amax * f32(1 / 127)``, floored at 1e-8: the reference's
    ``amax / 127.0`` as XLA compiles it under ``jax.jit``; the payload is
    rounded half to even against the f32 scale, before the scale is
    rounded to bf16, as the reference does."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) * (1.0 / 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 payload times its bf16 scale, rounded to ``dtype``: the cache
    the decode kernel reads (a torch op before the kernel; XLA fuses it
    into the attention's operand read on a TPU).  The reference's product
    is bf16, but under ``jax.jit`` XLA drops a bf16 rounding that an
    upcast follows: K, which its score product promotes to the query's
    dtype, is that dtype's product (f32 in float32 mode), while V stays
    bf16 because P is cast to V's dtype.  One elementwise kernel: the
    int8 payload widens exactly, and the product rounds once."""
    return q * scale[..., None].to(dtype)


# ---------------------------------------------------------------------------
# paged cache (block pool + per-slot block tables; serving/paged/)
# ---------------------------------------------------------------------------
def paged_cache_defs(cfg, n_slots: int, n_blocks: int, block_size: int,
                     max_blocks: int, kv_dtype: str = "bf16",
                     host_blocks: int = 0) -> Pytree:
    """Physical KV as a pool of fixed-size blocks shared by all slots,
    kernel-native ``(L, n_blocks, Hkv, block_size, Dh)`` (heads before
    positions); ``block_tables`` maps (slot, logical block) -> physical
    block, entry 0 being the null block.

    Tiered KV: ``kv_dtype`` in {"fp8", "int8"} stores the pool quantized,
    with f32 scale pools ``k_scale``/``v_scale`` (one scale per stored
    (head, position) vector); ``host_blocks > 0`` adds the host tier —
    ``host_k``/``host_v`` (with ``host_k_scale``/``host_v_scale`` when
    quantized) of ``host_blocks + 1`` blocks, host id 0 being its null
    block, plus per-slot ``host_tables`` and ``cold_lengths``.  The host
    pool lives on the same device as the rest of the cache, as the
    reference's unsharded host leaves live on its one device."""
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    kv = ParamDef((L, n_blocks, Hkv, block_size, Dh),
                  ("layers", "kv_blocks", "kv_heads", "kv_seq", "head_dim"), "zeros")
    defs = {
        "k": kv,
        "v": kv,
        "block_tables": ParamDef((n_slots, max_blocks), ("kv_batch", None), "zeros"),
        "lengths": ParamDef((n_slots,), ("kv_batch",), "zeros"),
    }
    quant = kv_dtype in ("fp8", "int8")
    if quant:
        sc = ParamDef((L, n_blocks, Hkv, block_size),
                      ("layers", "kv_blocks", "kv_heads", "kv_seq"), "zeros")
        defs["k_scale"] = sc
        defs["v_scale"] = sc
    if host_blocks > 0:
        hkv = ParamDef((L, host_blocks + 1, Hkv, block_size, Dh),
                       ("layers", None, "kv_heads", "kv_seq", "head_dim"), "zeros")
        defs["host_k"] = hkv
        defs["host_v"] = hkv
        defs["host_tables"] = ParamDef((n_slots, max_blocks), ("kv_batch", None), "zeros")
        defs["cold_lengths"] = ParamDef((n_slots,), ("kv_batch",), "zeros")
        if quant:
            hsc = ParamDef((L, host_blocks + 1, Hkv, block_size),
                           ("layers", None, "kv_heads", "kv_seq"), "zeros")
            defs["host_k_scale"] = hsc
            defs["host_v_scale"] = hsc
    return defs


# kv_dtype name -> pool storage dtype (scales are always f32)
PAGED_KV_DTYPES = {
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
    "int8": torch.int8,
}


def _kv_dtype_name(dtype: torch.dtype) -> str | None:
    """Storage dtype -> quantization name (None = unquantized)."""
    if dtype == torch.int8:
        return "int8"
    if dtype == torch.float8_e4m3fn:
        return "fp8"
    return None


def init_paged_cache(cfg, n_slots: int, n_blocks: int, block_size: int,
                     max_blocks: int, dtype=torch.bfloat16, kv_dtype: str = "bf16",
                     host_blocks: int = 0, device: torch.device | str = "cpu", *,
                     place: Placement | None = None) -> Pytree:
    """Zeroed paged pool of :func:`paged_cache_defs`.  On a mesh
    (``place``) a :class:`ShardedPool` of this rank's shards of ``k``,
    ``v`` and the scale pools, at the shapes the KV policy's specs give
    (``Model.paged_cache_specs``), with ``block_tables`` and ``lengths``
    whole on every rank (a few KB; every lane reads every row's table):
    a layout choice, which changes no result.  The host tier's leaves take
    the reference's specs (their block axis never split: every rank holds
    its KV heads and positions of every host block), ``host_tables`` and
    ``cold_lengths`` whole."""
    if cfg.kv_quant and kv_dtype == "bf16":
        kv_dtype = "int8"           # cfg-level quant maps onto the int8 tier
    defs = paged_cache_defs(cfg, n_slots, n_blocks, block_size, max_blocks,
                            kv_dtype=kv_dtype, host_blocks=host_blocks)
    pool_dt = PAGED_KV_DTYPES[kv_dtype] if kv_dtype != "bf16" else dtype
    dt = {"k": pool_dt, "v": pool_dt, "host_k": pool_dt, "host_v": pool_dt,
          "k_scale": torch.float32, "v_scale": torch.float32,
          "host_k_scale": torch.float32, "host_v_scale": torch.float32}
    if place is None:
        return {k: torch.zeros(d.shape, dtype=dt.get(k, torch.int32), device=device)
                for k, d in defs.items()}
    specs = {k: place.env.kv_spec(d.logical, d.shape) for k, d in defs.items()}
    sp = specs["k"]
    split = {"k", "v", "k_scale", "v_scale", "host_k", "host_v", "host_k_scale",
             "host_v_scale"}
    leaves = {k: torch.zeros(place.local_shape(specs[k], d.shape) if k in split else d.shape,
                             dtype=dt.get(k, torch.int32), device=device)
              for k, d in defs.items()}
    nbytes = sum(math.prod(d.shape) * leaves[k].element_size() for k, d in defs.items())
    host = {}
    if host_blocks:             # its heads are the pool's: one rule on one count
        hs = specs["host_k"]
        host = dict(host_pos=place.part(hs.axes(3), block_size), host_pos_axes=hs.axes(3))
    return ShardedPool(leaves, place=place, n_blocks=n_blocks, n_kv=cfg.n_kv_heads,
                       block_size=block_size, blocks=place.part(sp.axes(1), n_blocks),
                       heads=place.part(sp.axes(2), cfg.n_kv_heads),
                       pos=place.part(sp.axes(3), block_size),
                       block_axes=sp.axes(1), head_axes=sp.axes(2), pos_axes=sp.axes(3),
                       nbytes=nbytes, **host)


def paged_decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor, *,
                      place: Placement | None = None):
    """One autoregressive step against the paged pool: ``decode_step``'s
    math, with the new K/V scattered to ``(tables[b, len // bs], len %
    bs)`` and attention reading each row's blocks through its table.

    Idle slots (table all-null) write into null block 0 (of the scale
    pools too); several may hit the same position there, and the winner
    is left undefined, which is harmless because no kernel reads a
    position at or past ``lengths``.  An idle slot whose length ran past
    ``max_blocks * bs`` reads table column ``max_blocks - 1`` (JAX clamps
    that gather; the port clamps the index without a host sync) — still
    the null block.

    The cache's leaves select the tier, as in the reference: an fp8/int8
    pool (``k_scale`` present) appends the new K/V quantized and the
    attention dequantizes it; with a host tier (``host_k`` present) every
    layer attends twice — the hot window ``[cold_len, len]`` of the device
    pool and the cold prefix ``[0, cold_len)`` in the host pool, each
    through the paged kernel on the GPU (the kernel-level oracle on the
    CPU) — and merges the two by log-sum-exp, so a spilled sequence
    keeps decoding without a re-prefill.  A slot with nothing spilled has
    an empty cold window, whose merge weight is 0.  On a mesh (``place``)
    every rank returns the whole batch's logits: :func:`_placed_paged`."""
    if place is not None:
        logits, rows = _placed_paged(cfg, place, params, cache, tokens)
        return place.gather(logits, 0, rows), cache
    return _paged_pass(cfg, params, cache, tokens, past_table_to_null=False)


def _paged_pass(cfg, params, cache: Pytree, tokens: torch.Tensor, *,
                past_table_to_null: bool):
    """:func:`paged_decode_step`'s body.  A row whose append position lies
    past its table writes to table column ``max_blocks - 1`` (JAX's
    clamped gather), or with ``past_table_to_null`` to null block 0 (the
    verify step's overshoot)."""
    lengths = cache["lengths"]
    tables = cache["block_tables"]
    bs = cache["k"].shape[3]
    MB = tables.shape[1]
    B = tokens.shape[0]
    quant = _kv_dtype_name(cache["k"].dtype)            # None | "fp8" | "int8"
    hosted = "host_k" in cache
    cold = cache["cold_lengths"] if hosted else None
    x = cm.embed_lookup(params["embed"], tokens)                # (B, D)
    pos = lengths.long()
    bidx = torch.arange(B, device=x.device)
    blk = pos // bs
    phys = tables[bidx, blk.clamp(max=MB - 1)].long()           # (B,) append block
    if past_table_to_null:
        phys = torch.where(blk < MB, phys, 0)
    off = pos % bs
    attn_len = lengths + 1
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(cm.linear(h, p["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        v = cm.linear(h, p["wv"])
        k_l, v_l = cache["k"][l], cache["v"][l]                 # (N, Hkv, bs, Dh)
        ks_l = vs_l = None
        # advanced indices around the head slice: the selection is (B, Hkv, Dh)
        if quant:
            ks_l, vs_l = cache["k_scale"][l], cache["v_scale"][l]   # (N, Hkv, bs)
            for pool, spool, new in ((k_l, ks_l, k), (v_l, vs_l, v)):
                payload, sc = ref.kv_quantize(new, quant)
                ref.byte_view(pool)[phys, :, off] = ref.byte_view(payload)
                spool[phys, :, off] = sc
        else:
            k_l[phys, :, off] = k.to(k_l.dtype)
            v_l[phys, :, off] = v.to(v_l.dtype)
        if hosted:
            o, lse_hot = offload.paged_decode_attention(
                q, k_l, v_l, tables, attn_len, starts=cold, k_scale=ks_l, v_scale=vs_l,
                return_lse=True)
            o_cold, lse_cold = offload.paged_decode_attention(
                q, cache["host_k"][l], cache["host_v"][l], cache["host_tables"], cold,
                k_scale=cache["host_k_scale"][l] if quant else None,
                v_scale=cache["host_v_scale"][l] if quant else None, return_lse=True)
            o = ref.lse_merge([(o, lse_hot), (o_cold, lse_cold)])
        else:
            o = offload.paged_decode_attention(q, k_l, v_l, tables, attn_len,
                                               k_scale=ks_l, v_scale=vs_l)
        x = x + cm.linear(o, p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, _unembed_table(params), cfg.vocab)
    lengths.add_(1)
    return logits, cache


# ---------------------------------------------------------------------------
# forward (train / prefill shared block)
# ---------------------------------------------------------------------------
def _embed(params, tokens: torch.Tensor, embeds: torch.Tensor | None):
    """Token embeddings (B, S', D), a stub frontend's ``embeds`` prepended,
    and their positions (B, S)."""
    x = cm.embed_lookup(params["embed"], tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    return x, torch.arange(S, device=x.device).expand(B, S)


def _attn(cfg, p, x: torch.Tensor, positions: torch.Tensor, group=None):
    """The pre-norm causal attention sublayer of a whole sequence (prefill
    and training): ``(x + attention, k, v)``.  On a mesh ``group`` is the
    heads' process group: the normed input enters the column-parallel
    projections through ``copy_to`` and the row-parallel output
    projection's partials are summed by ``reduce_from``."""
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if group is not None:
        h = collectives.copy_to(h, group)
    q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
    k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
    v = cm.linear(h, p["wv"])
    o = offload.prefill_attention(q, k, v)
    return x + collectives.reduce_from(cm.linear(o, p["wo"], n_in=2), group), k, v


def _block_train(cfg, p, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = _attn(cfg, p, x, positions)[0]
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def hidden_states(cfg, params, tokens: torch.Tensor,
                  embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token (+ optional prepended frontend) embeddings -> final hidden
    (B, S, D), each layer's block recomputed in the backward.  The
    attention of a CUDA input that needs a gradient runs the flash kernel
    with its log-sum-exp and the flash backward kernel."""
    x, positions = _embed(params, tokens, embeds)
    for p in cm.unstack(params["blocks"]):
        x = cm.remat(_block_train, cfg, p, x, positions)
    return cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg, params, batch: dict, *, place: Placement | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE of ``batch`` (``inputs``, ``targets``, optional
    ``mask`` and ``embeds``; the loss covers token positions only) ->
    ``(loss, {"loss": loss})``.  On a mesh (``place``):
    :func:`_placed_loss`."""
    if place is not None:
        return _placed_loss(cfg, place, params, batch)
    hid = hidden_states(cfg, params, batch["inputs"], batch.get("embeds"))
    n_front = 0 if "embeds" not in batch else batch["embeds"].shape[1]
    logits = cm.unembed(hid[:, n_front:], _unembed_table(params), cfg.vocab)
    loss = cm.cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def prefill(cfg, params, tokens: torch.Tensor, cache: Pytree,
            embeds: torch.Tensor | None = None, *, place: Placement | None = None):
    """Fill the cache with the S context tokens ``tokens (B, S)``; return
    last-position logits ``(B, V)`` and the cache.

    ``embeds (B, F, d_model)``, a stub frontend's, are prepended to the
    token embeddings and take cache positions ``[0, F)``, so S counts
    them.  K/V are written in place at positions ``[0, S)`` of ``cache``,
    which may be a view of a larger cache (the engine passes one slot's
    stripe); ``lengths`` is set to S.  With ``kv_quant`` each layer
    attends over its unquantized K/V and writes them quantized, as the
    reference does.  On a mesh (``place``): :func:`_placed_prefill`."""
    if place is not None:
        return _placed_prefill(cfg, place, params, tokens, cache, embeds)
    x, positions = _embed(params, tokens, embeds)
    S = x.shape[1]
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        x, k, v = _attn(cfg, p, x, positions)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        for name, new in (("k", k), ("v", v)):
            if cfg.kv_quant:
                new, sc = _kv_quantize(new)
                cache[f"{name}_scale"][l, :, :S].copy_(sc)
            cache[name][l, :, :S].copy_(new)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x[:, -1], _unembed_table(params), cfg.vocab)
    cache["lengths"].fill_(S)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _append(cache_l: torch.Tensor, new: torch.Tensor, bidx: torch.Tensor,
            pos: torch.Tensor, valid: torch.Tensor) -> None:
    """Write ``new (B, ...)`` (K/V ``(B, Hkv, Dh)``, or their scales
    ``(B, Hkv)``) at ``cache_l[b, pos[b]]`` in place, for the rows where
    ``valid``.  A row at ``pos >= max_seq`` (an idle slot that has run
    past the end; JAX drops such scatter writes, CUDA would fault on them)
    rewrites what is already there, without a host sync."""
    old = cache_l[bidx, pos]
    keep = valid.view(-1, *(1,) * (new.dim() - 1))
    cache_l.index_put_((bidx, pos), torch.where(keep, new.to(cache_l.dtype), old))


def decode_step(cfg, params, cache: Pytree, tokens: torch.Tensor, *,
                place: Placement | None = None):
    """One autoregressive step.  tokens (B,) -> logits (B, V), cache.

    Every slot advances, idle ones included, as in the reference: the
    new token's K/V land at ``lengths`` (skipped where ``lengths >=
    max_seq``) and ``lengths`` grows by one, in place.  With ``kv_quant``
    the new K/V are appended quantized with their scales, and each layer's
    cache is dequantized for the decode kernel (:func:`_kv_dequantize`).
    On a mesh (``place``) every rank returns the whole batch's logits:
    :func:`_placed_decode`'s rows gathered."""
    if place is not None:
        logits, rows = _placed_decode(cfg, place, params, cache, tokens)
        return place.gather(logits, 0, rows), cache
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
        if cfg.kv_quant:
            ks_l, vs_l = cache["k_scale"][l], cache["v_scale"][l]
            for pool, spool, new in ((k_l, ks_l, k), (v_l, vs_l, v)):
                payload, sc = _kv_quantize(new)
                _append(pool, payload, bidx, wpos, valid)
                _append(spool, sc, bidx, wpos, valid)
            k_l = _kv_dequantize(k_l, ks_l, torch.promote_types(q.dtype, torch.bfloat16))
            v_l = _kv_dequantize(v_l, vs_l)
        else:
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


# ---------------------------------------------------------------------------
# chunked prefill (Sarathi-style continuation; serving/scheduler.py)
# ---------------------------------------------------------------------------
def _device_scalar(x, device: torch.device) -> torch.Tensor:
    """``x`` as a ``(1,)`` int32 tensor on ``device``: a tensor as it is
    (a captured program's scalar), a host int copied there."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1)
    return torch.tensor([x], dtype=torch.int32).to(device)


def prefill_step(cfg, params, cache: Pytree, tokens: torch.Tensor, slot, q_offset, n_valid,
                 *, place: Placement | None = None):
    """One chunk of one slot's prompt against the live cache.

    ``tokens`` (1, C) is the chunk, padded; ``slot``, ``q_offset`` and
    ``n_valid`` are ``(1,)`` int32 tensors on the cache's device (as the
    reference traces them: a captured CUDA graph serves every slot,
    offset and length) or host ints.  Nothing here reads them on the
    host.  The chunk's K/V land at positions ``q_offset .. q_offset+C-1``
    of ``slot``'s stripe — positions past the stripe are dropped, as JAX
    drops them; in-range pad garbage is causally masked and overwritten by
    the next chunk or decode append.  Attention runs at ``q_offset``
    against the stripe, ``lengths[slot]`` becomes ``q_offset + n_valid``,
    and the logits (1, V) are those of chunk position ``n_valid - 1``.
    ``cache`` may be the dense cache or the paged engine's staging cache
    (``slot`` is then the staging lane).

    The write goes through a window of ``C`` distinct positions starting
    at ``min(q_offset, S - C)`` (so ``C <= S``): a window position outside
    ``[q_offset, q_offset + C)`` is rewritten with its own value.  A
    clamped index instead would repeat positions, and CUDA leaves the
    winner of repeated ``index_put_`` positions undefined, so a clamped
    pad write could race with the valid write at ``S - 1``.  On a mesh
    (``place``): :func:`_placed_prefill_step`."""
    if cfg.kv_quant:
        raise NotImplementedError("chunked prefill does not support kv_quant yet")
    if place is not None:
        return _placed_prefill_step(cfg, place, params, cache, tokens, slot, q_offset, n_valid)
    C = tokens.shape[1]
    S = cache["k"].shape[2]
    if C > S:
        raise ValueError(f"prefill_step: a chunk of {C} does not fit a stripe of {S}")
    dev = tokens.device
    slot, q_offset, n_valid = (_device_scalar(a, dev) for a in (slot, q_offset, n_valid))
    x = cm.embed_lookup(params["embed"], tokens)                # (1, C, D)
    ar = torch.arange(C, device=dev)
    positions = (q_offset + ar)[None]
    win = q_offset.clamp(max=S - C) + ar                        # (C,) distinct positions
    src = win - q_offset                                        # their chunk rows
    keep = ((src < 0) | (src >= C))[:, None, None]
    src = src.clamp(0, C - 1)
    rows, win = slot.long().expand(C), win.long()
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
        k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
        v = cm.linear(h, p["wv"])
        k_l, v_l = cache["k"][l], cache["v"][l]                 # (B, S, Hkv, Dh)
        for pool, new in ((k_l, k), (v_l, v)):
            pool.index_put_((rows, win),
                            torch.where(keep, pool[rows, win], new[0, src].to(pool.dtype)))
        # the slot's stripe (1, S, Hkv, Dh), gathered at the device slot
        o = offload.prefill_attention(q, k_l.index_select(0, slot), v_l.index_select(0, slot),
                                      q_offset=q_offset)
        x = x + cm.linear(o, p["wo"], n_in=2)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    last = x.index_select(1, (n_valid - 1).long())[:, 0]        # (1, D)
    logits = cm.unembed(last, _unembed_table(params), cfg.vocab)
    cache["lengths"].index_put_((slot.long(),), q_offset + n_valid)
    return logits, cache


# ---------------------------------------------------------------------------
# speculative verify (draft-verify decoding; serving/engine.py)
# ---------------------------------------------------------------------------
def verify_step(cfg, params, cache: Pytree, tokens: torch.Tensor, *,
                place: Placement | None = None):
    """Score T speculative tokens per slot: ``tokens (B, T)`` are each
    slot's next inputs ``[t0, d_1 .. d_{T-1}]``, input ``t`` landing at
    position ``lengths[b] + t``.  Returns logits ``(B, T, V)``, position
    ``t`` scoring the successor of input ``t``, and the cache with the K/V
    of all T positions written (positions past ``max_seq`` dropped) and
    ``lengths`` as it was: the caller commits ``lengths + n_accept + 1``.

    T :func:`decode_step` passes, the same arithmetic op for op as plain
    decoding (so T calls per layer of the decode kernel, not one T-wide
    attention): greedy speculative output must be token-identical to
    plain decoding, and a differently shaped attention rounds bf16 logits
    differently.  On a mesh (``place``) each pass is the placed
    :func:`decode_step`, so every rank returns the whole batch's logits."""
    if cfg.kv_quant:
        raise NotImplementedError("verify_step does not support kv_quant yet")
    saved = cache["lengths"].clone()
    logits = []
    for t in range(tokens.shape[1]):
        lg, _ = decode_step(cfg, params, cache, tokens[:, t], place=place)
        logits.append(lg)
    cache["lengths"].copy_(saved)
    return torch.stack(logits, dim=1), cache


def paged_verify_step(cfg, params, cache: Pytree, tokens: torch.Tensor, *,
                      place: Placement | None = None):
    """Paged-pool analogue of :func:`verify_step`: T
    :func:`paged_decode_step` passes, except that a position past the
    block table (a verify window overshooting the cache's edge) goes to
    null block 0, the pool's garbage sink, and not through the clamped
    column, which may be a live block.  Quantized pools and the host tier
    are refused, as in the reference.  On a mesh (``place``) each pass is
    the placed step (:func:`_placed_paged`), its rows gathered."""
    if _kv_dtype_name(cache["k"].dtype):
        raise NotImplementedError("paged_verify_step: quantized pools unsupported")
    if "host_k" in cache:
        raise NotImplementedError("paged_verify_step: host KV tier unsupported")
    saved = cache["lengths"].clone()
    logits = []
    for t in range(tokens.shape[1]):
        if place is not None:
            lg, rows = _placed_paged(cfg, place, params, cache, tokens[:, t],
                                     past_table_to_null=True)
            lg = place.gather(lg, 0, rows)
        else:
            lg, _ = _paged_pass(cfg, params, cache, tokens[:, t], past_table_to_null=True)
        logits.append(lg)
    cache["lengths"].copy_(saved)
    return torch.stack(logits, dim=1), cache


def prefill_sample_step(cfg, params, cache: Pytree, tokens: torch.Tensor, slot, q_offset,
                        n_valid, generator: torch.Generator | None, *, sampler,
                        place: Placement | None = None):
    """Chunked prefill with the first generated token sampled on the
    device: (token (1,), cache).  Only a prompt's final chunk's token is
    used.  On a mesh every rank holds the whole logits and draws the same
    token from its generator, seeded alike."""
    logits, cache = prefill_step(cfg, params, cache, tokens, slot, q_offset, n_valid,
                                 place=place)
    return sample_on_device(logits, generator, sampler), cache


def decode_sample_step(cfg, params, cache: Pytree, tokens: torch.Tensor,
                       generator: torch.Generator | None, eos_ids: torch.Tensor, *,
                       sampler, place: Placement | None = None):
    """One decode step with sampling fused: (tokens', eos_hit, cache).
    Only ``(B,)`` ids leave the device; nothing here waits on it.  On a
    mesh each rank samples its rows and the ids are gathered, so every
    rank holds the same ``(B,)``."""
    if place is not None:
        logits, rows = _placed_decode(cfg, place, params, cache, tokens)
        tok = _placed_sample(place, logits, rows, tokens.shape[0], generator, sampler)
        return tok, tok == eos_ids, cache
    logits, cache = decode_step(cfg, params, cache, tokens)
    tok = sample_on_device(logits, generator, sampler)
    return tok, tok == eos_ids, cache


def paged_decode_sample_step(cfg, params, cache: Pytree, tokens: torch.Tensor,
                             generator: torch.Generator | None, eos_ids: torch.Tensor, *,
                             sampler, place: Placement | None = None):
    """Paged-pool analogue of :func:`decode_sample_step`."""
    if place is not None:
        logits, rows = _placed_paged(cfg, place, params, cache, tokens)
        tok = _placed_sample(place, logits, rows, tokens.shape[0], generator, sampler)
        return tok, tok == eos_ids, cache
    logits, cache = paged_decode_step(cfg, params, cache, tokens)
    tok = sample_on_device(logits, generator, sampler)
    return tok, tok == eos_ids, cache


# ---------------------------------------------------------------------------
# placement on a mesh (``core.offload.Placement``; serving on the dense
# cache and the paged pool, and training).  The compute side is tensor
# parallel on the weights' split: wq / wk / wv and w_gate / w_up by columns, wo and w_down
# by rows with one all-reduce after each, the embedding by vocabulary rows
# (a masked lookup and an all-reduce) and the logits gathered over the
# vocabulary (serving) or kept split into a vocabulary-parallel
# cross-entropy (training); activations are split by rows over the batch
# axes.  With ``Env.fsdp`` every weight's d_model dim is also split over
# the batch axes and gathered before use (:func:`_whole`).  The cache is a
# ShardedCache in its policy's layout; K/V are written where it holds
# them, and decode attention goes through offload.placed_decode_attention.
# The paged pool is a ShardedPool (blocks, KV heads or the positions in a
# block over its lanes), read through offload.placed_paged_decode_attention.
# Training writes every collective's transpose out
# (``collectives.copy_to`` / ``reduce_from`` / ``gather_from``).
# ---------------------------------------------------------------------------
# the dim each block weight is split on
_TP_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2, "w_up": 2, "w_down": 1}
# the mesh axes FSDP splits the weights' d_model over (the batch axes)
BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    heads: tuple[str, ...]     # query and KV heads
    mlp: tuple[str, ...]       # FFN hidden
    vocab: tuple[str, ...]     # embedding / unembedding rows


def tensor_parallel(specs: Pytree) -> TensorParallel:
    """The axes the weights' specs split, when they are the layout above
    (FSDP's split of d_model over the batch axes aside, in a dim of its
    own); raises for another (the row-parallel fallback of a head count
    the model axis does not divide)."""
    leaves = [*specs["blocks"].values()] + [sp for k, sp in specs.items() if k != "blocks"]
    mixed = any(len(set(sp.axes(d)) & set(BATCH_AXES)) not in (0, len(sp.axes(d)))
                for sp in leaves for d in range(len(sp)))
    blocks = {n: sp.without(BATCH_AXES) for n, sp in specs["blocks"].items()}
    ok = all([i for i in range(len(sp)) if sp.axes(i)] in ([], [_TP_DIMS.get(n)])
             for n, sp in blocks.items())
    heads = {blocks[n].axes(_TP_DIMS[n]) for n in ("wq", "wk", "wv", "wo")}
    mlp = {blocks[n].axes(_TP_DIMS[n]) for n in ("w_gate", "w_up", "w_down")}
    tables = [specs[n].without(BATCH_AXES) for n in ("embed", "unembed") if n in specs]
    vocab = {t.axes(0) for t in tables}
    if (mixed or not ok or len(heads) > 1 or len(mlp) > 1 or len(vocab) > 1
            or any(t.axes(1) for t in tables)
            or specs["final_norm"].without(BATCH_AXES).axes(0)):
        raise NotImplementedError(
            f"placement: the dense model runs column/row tensor parallel weights only; "
            f"specs {specs}")
    return TensorParallel(heads.pop(), mlp.pop(), vocab.pop())


def _whole(place: Placement, spec, w: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """``w``, this rank's shard of a weight under ``spec``, with its FSDP
    dims (split over the batch axes) gathered: the tensor-parallel shard
    the computation uses.  ``lead`` counts the leading dims of ``spec``
    that ``w`` lacks (1 for a layer's slice of a stacked weight).  Under
    autograd the gradient is reduce-scattered back over those axes."""
    for d in range(lead, len(spec)):
        axes = tuple(a for a in spec.axes(d) if a in BATCH_AXES)
        if place.split(axes):
            w = collectives.gather_from(w, place.mesh.group(axes), d - lead)
    return w


def _placed_layer(place: Placement, params, l: int) -> dict[str, torch.Tensor]:
    """Layer ``l``'s tensor-parallel weights (FSDP's split gathered)."""
    return {k: _whole(place, place.specs["blocks"][k], v, 1)
            for k, v in _layer(params, l).items()}


def _placed_table(place: Placement, params, name: str) -> torch.Tensor:
    return _whole(place, place.specs[name], params[name])


def _placed_embed(place: Placement, tp: TensorParallel, table: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's vocabulary rows: 0 for
    a token held elsewhere, then summed over the vocabulary's axes (one
    term is not 0: exact)."""
    if not place.split(tp.vocab):
        return cm.embed_lookup(table, tokens)
    n = table.shape[0]
    v0, _ = place.part(tp.vocab, n * place.mesh.size(tp.vocab))
    t = tokens.long() - v0
    inside = ((t >= 0) & (t < n))[..., None]
    x = torch.where(inside, table[t.clamp(0, n - 1)], torch.zeros((), dtype=table.dtype,
                                                                   device=table.device))
    return collectives.reduce_from(x, place.mesh.group(tp.vocab))


def _placed_unembed_table(place: Placement, params, table: torch.Tensor) -> torch.Tensor:
    """The unembedding's rows of this rank: ``table`` (the embedding's,
    gathered) when tied."""
    return table if "unembed" not in params else _placed_table(place, params, "unembed")


def _placed_logits(cfg, place: Placement, tp: TensorParallel, params, table: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """x (b, D) -> logits (b, V) over the whole (padded) vocabulary, the
    pad masked: this rank's columns gathered over the vocabulary's axes
    (``table``: the embedding's rows of this rank, gathered)."""
    logits = place.gather(x @ _placed_unembed_table(place, params, table).t(), -1, tp.vocab)
    if cfg.vocab < logits.shape[-1]:
        logits[..., cfg.vocab:] = -1e30
    return logits


def _placed_ffn(cfg, place: Placement, tp: TensorParallel, p, x: torch.Tensor):
    """The FFN sublayer over this rank's columns of the FFN, entered by
    ``copy_to`` and left by ``reduce_from`` over the FFN's axes."""
    mlp = place.mesh.group(tp.mlp)
    h = collectives.copy_to(cm.rmsnorm(x, p["ln2"], cfg.norm_eps), mlp)
    return x + collectives.reduce_from(cm.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), mlp)


def _rows(place: Placement, n: int) -> tuple[str, ...]:
    """The axes a batch of ``n`` rows is split over on the compute side."""
    return place.env.act_spec(("batch",), (n,)).axes(0)


def _placed_block_train(cfg, place: Placement, tp: TensorParallel, specs, p,
                        x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """:func:`_block_train` of this rank's rows and heads: the weights'
    FSDP split gathered, each tensor-parallel section entered by
    ``copy_to`` (its backward sums the partial gradients over the section's
    axes) and left by ``reduce_from``."""
    p = {k: _whole(place, specs[k], v, 1) for k, v in p.items()}
    x = _attn(cfg, p, x, positions, place.mesh.group(tp.heads))[0]
    return _placed_ffn(cfg, place, tp, p, x)


def _placed_loss(cfg, place: Placement, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """:func:`loss_fn` on a mesh, differentiable.  ``batch`` is the whole
    (global) batch on every rank; each rank takes its rows (the batch
    must divide over the batch axes: a rank holding rows that another
    also holds would count their gradients twice), runs every layer
    tensor parallel over its heads and FFN columns (each block recomputed
    in the backward, the flash lse forward and backward kernels over the
    rank's heads on CUDA), and the unembedding over its vocabulary rows
    into :func:`common.vocab_parallel_cross_entropy`.  Every rank returns
    the whole batch's loss; the gradients are this rank's shards', summed
    over the model axis and, for FSDP's split, over the batch axes, and
    partial over the batch axes a weight is not split over (the trainer
    reduces them)."""
    tp = tensor_parallel(place.specs)
    tokens = batch["inputs"]
    B = tokens.shape[0]
    rows = _rows(place, B)
    if place.mesh.size(rows) != place.mesh.size(BATCH_AXES):
        raise ValueError(f"placement: a batch of {B} rows does not divide over the batch axes "
                         f"of {place.mesh}")
    a0, a1 = place.part(rows, B)
    table = _placed_table(place, params, "embed")
    x = _placed_embed(place, tp, table, tokens[a0:a1])
    embeds = batch.get("embeds")
    n_front = 0 if embeds is None else embeds.shape[1]
    if embeds is not None:
        x = torch.cat([embeds[a0:a1].to(x.dtype), x], dim=1)
    b, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(b, S)
    for p in cm.unstack(params["blocks"]):
        x = cm.remat(_placed_block_train, cfg, place, tp, place.specs["blocks"], p, x,
                     positions)
    x = cm.rmsnorm(x, _placed_table(place, params, "final_norm"), cfg.norm_eps)
    vocab = place.mesh.group(tp.vocab)
    utable = _placed_unembed_table(place, params, table)
    logits = collectives.copy_to(x[:, n_front:], vocab) @ utable.t()
    n = utable.shape[0]
    v0 = place.part(tp.vocab, n * place.mesh.size(tp.vocab))[0]
    if cfg.vocab < v0 + n:
        cols = torch.arange(v0, v0 + n, device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    mask = batch.get("mask")
    loss = cm.vocab_parallel_cross_entropy(logits, batch["targets"][a0:a1],
                                           None if mask is None else mask[a0:a1], v0, vocab,
                                           place.mesh.group(rows))
    return loss, {"loss": loss}


def _placed_prefill(cfg, place: Placement, params, tokens: torch.Tensor,
                    cache: ShardedCache, embeds: torch.Tensor | None = None):
    """:func:`prefill` on a mesh: each rank runs the flash kernel over its
    rows and heads, and writes the K/V of the positions ``[0, S)`` that
    its shard of the cache holds (a slot's view: only on the rank that
    owns the slot); a cache with scale leaves (``kv_quant``) takes them
    quantized, per (row, position, head) vector over head_dim, which no
    policy splits, so a rank writes the bytes one device writes there.  A
    frontend's ``embeds`` (whole on every rank) are prepended to this
    rank's rows.  Every rank returns the whole batch's logits."""
    tp = tensor_parallel(place.specs)
    b = tokens.shape[0]
    rows = _rows(place, b)
    a0, a1 = place.part(rows, b)
    table = _placed_table(place, params, "embed")
    x = _placed_embed(place, tp, table, tokens[a0:a1])
    if embeds is not None:
        x = torch.cat([embeds[a0:a1].to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device).expand(a1 - a0, S)
    s0, s1 = cache.seq
    w0, w1 = min(s0, S), min(s1, S)            # this shard's positions of the prompt
    full = [b, S, cache.n_kv, cache["k"].shape[-1]]
    dst = [(cache.row_axes, cache.rows), ((), (w0, w1)), (cache.head_axes, cache.heads),
           ((), (0, full[3]))]
    for l in range(cfg.n_layers):
        p = _placed_layer(place, params, l)
        x, k, v = _attn(cfg, p, x, positions, place.mesh.group(tp.heads))
        x = _placed_ffn(cfg, place, tp, p, x)
        k, v = place.reshard_all([k, v], [rows, (), tp.heads, ()], [dst, dst], [full, full])
        if w1 > w0:                            # then w0 == s0
            for name, new in (("k", k), ("v", v)):
                if "k_scale" in cache:
                    new, sc = _kv_quantize(new)
                    cache[f"{name}_scale"][l, :, :w1 - w0].copy_(sc)
                cache[name][l, :, :w1 - w0].copy_(new)
    x = cm.rmsnorm(x, _placed_table(place, params, "final_norm"), cfg.norm_eps)
    logits = _placed_logits(cfg, place, tp, params, table, x[:, -1])
    cache["lengths"].fill_(S)
    return place.gather(logits, 0, rows), cache


def _placed_decode_layers(cfg, place: Placement, params, tokens: torch.Tensor,
                          rows: tuple[str, ...], pos: torch.Tensor, layout, write, attend):
    """The layers of a decode step on a mesh, over this rank's rows
    (``rows``, at positions ``pos``) and tensor-parallel heads, up to their
    logits (b, V).  The cache decides the rest: ``layout(n)`` is its
    layout of ``n`` heads, which q, k and v go to in one collective a dim;
    ``write(l, k, v)`` stores layer ``l``'s new K/V there and
    ``attend(l, q, compute)`` returns the attention in the compute layout
    ``compute``."""
    tp = tensor_parallel(place.specs)
    B = tokens.shape[0]
    a0, a1 = place.part(rows, B)
    table = _placed_table(place, params, "embed")
    x = _placed_embed(place, tp, table, tokens[a0:a1])
    Dh, Hq, n_kv = cfg.resolved_head_dim(), cfg.n_heads, cfg.n_kv_heads
    for l in range(cfg.n_layers):
        p = _placed_layer(place, params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(cm.linear(h, p["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        v = cm.linear(h, p["wv"])
        q, k, v = place.reshard_all([q, k, v], [rows, tp.heads, ()],
                                    [layout(n) for n in (Hq, n_kv, n_kv)],
                                    [[B, n, Dh] for n in (Hq, n_kv, n_kv)])
        write(l, k, v)
        o = attend(l, q.contiguous(), [rows, tp.heads])
        x = x + place.reduce(cm.linear(o, p["wo"], n_in=2), tp.heads)
        x = _placed_ffn(cfg, place, tp, p, x)
    x = cm.rmsnorm(x, _placed_table(place, params, "final_norm"), cfg.norm_eps)
    return _placed_logits(cfg, place, tp, params, table, x)


def _placed_decode(cfg, place: Placement, params, cache: ShardedCache, tokens: torch.Tensor):
    """:func:`decode_step` on a mesh, up to the logits of this rank's rows:
    ``(logits (b, V), the axes the rows are split over)``.  The new K/V
    go to the cache's layout and land where a row's append position
    falls in this shard's window (skipped at or past ``max_seq``); the
    ``kv_quant`` cache takes them quantized, and each rank dequantizes its
    shard for the decode kernel (K in the query's dtype, V in bf16)."""
    B = tokens.shape[0]
    rows = _rows(place, B)
    lengths = cache["lengths"]
    pos = place.reshard(lengths, [cache.row_axes], [(rows, place.part(rows, B))], [B]).long()
    s0, s1 = cache.seq
    local = lengths.long() - s0
    valid = (lengths < cache.max_seq) & (local >= 0) & (local < s1 - s0)
    wpos = local.clamp(0, s1 - s0 - 1)
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    Dh = cache["k"].shape[-1]

    quant = "k_scale" in cache

    def write(l, k, v):
        for name, new in (("k", k), ("v", v)):
            if quant:
                new, sc = _kv_quantize(new)
                _append(cache[f"{name}_scale"][l], sc, bidx, wpos, valid)
            _append(cache[name][l], new, bidx, wpos, valid)

    def attend(l, q, compute):
        kv = None
        if quant:                # this rank's shard dequantized, as one device does
            kv = (_kv_dequantize(cache["k"][l], cache["k_scale"][l],
                                 torch.promote_types(q.dtype, torch.bfloat16)),
                  _kv_dequantize(cache["v"][l], cache["v_scale"][l]))
        return offload.placed_decode_attention(place, cache, l, q, compute, lengths + 1, kv)

    logits = _placed_decode_layers(
        cfg, place, params, tokens, rows, pos, lambda n: offload.cache_layout(cache, n, Dh),
        write, attend)
    lengths.add_(1)
    return logits, rows


def _placed_sample(place: Placement, logits: torch.Tensor, rows: tuple[str, ...], B: int,
                   generator: torch.Generator | None, sampler) -> torch.Tensor:
    """Each rank samples its rows' logits (the draws of those rows of the
    whole batch's) and the ids are gathered: every rank holds the same
    ``(B,)``."""
    lo, hi = place.part(rows, B)
    return place.gather(sample_on_device(logits, generator, sampler, (lo, hi, B)), 0, rows)


def _placed_prefill_step(cfg, place: Placement, params, cache: ShardedCache,
                         tokens: torch.Tensor, slot, q_offset, n_valid):
    """:func:`prefill_step` on a mesh.  Every rank runs the chunk (one row,
    which the compute side does not split) over its heads.  The chunk's
    K/V go to the cache's layout and land where this shard holds the
    slot's row and the positions (a window of distinct local positions, as
    on one device); the attention reads the slot's stripe in the compute
    layout: the row from the rank that holds it (a sum over the row axes,
    zeros elsewhere), gathered over the positions' and heads' axes as
    their split asks.  The paged engine's staging cache is in the compute
    layout (``init_cache(..., staging=True)``): there both moves are
    nothing.  Every rank returns the whole logits."""
    tp = tensor_parallel(place.specs)
    C, S = tokens.shape[1], cache.max_seq
    if C > S:
        raise ValueError(f"prefill_step: a chunk of {C} does not fit a stripe of {S}")
    dev = tokens.device
    slot, q_offset, n_valid = (_device_scalar(a, dev) for a in (slot, q_offset, n_valid))
    table = _placed_table(place, params, "embed")
    x = _placed_embed(place, tp, table, tokens)                       # (1, C, D)
    positions = (q_offset + torch.arange(C, device=dev))[None]
    (r0, r1), (s0, s1) = cache.rows, cache.seq
    n = s1 - s0
    cl = min(C, n)
    win = (q_offset - s0).clamp(0, n - cl) + torch.arange(cl, device=dev)   # local positions
    src = win + s0 - q_offset                                         # their chunk rows
    row = slot.long() - r0
    held = (row >= 0) & (row < r1 - r0)
    keep = ((src < 0) | (src >= C) | ~held)[:, None, None]
    src = src.clamp(0, C - 1)
    row = row.clamp(0, max(r1 - r0 - 1, 0))
    rows_i, win = row.expand(cl), win.long()
    Dh, n_kv = cache["k"].shape[-1], cache.n_kv
    dst = [((), (0, 1)), ((), (0, C)), (cache.head_axes, cache.heads), ((), (0, Dh))]
    stripe = [((), (0, 1)), ((), (0, S)), (tp.heads, place.part(tp.heads, n_kv)), ((), (0, Dh))]
    for l in range(cfg.n_layers):
        p = _placed_layer(place, params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q = cm.rope(cm.linear(h, p["wq"]), positions, cfg.rope_theta)
        k = cm.rope(cm.linear(h, p["wk"]), positions, cfg.rope_theta)
        v = cm.linear(h, p["wv"])
        k, v = place.reshard_all([k, v], [(), (), tp.heads, ()], [dst, dst],
                                 [[1, C, n_kv, Dh]] * 2)
        kv = []
        for pool, new in ((cache["k"][l], k), (cache["v"][l], v)):
            if r1 > r0 and cl > 0:
                pool.index_put_((rows_i, win), torch.where(keep, pool[rows_i, win],
                                                           new[0, src].to(pool.dtype)))
            part = pool.index_select(0, row) if r1 > r0 else pool.new_zeros(1, *pool.shape[1:])
            if place.split(cache.row_axes):
                part = place.reduce(torch.where(held.view(1, 1, 1, 1), part,
                                                torch.zeros_like(part)),
                                    cache.row_axes)
            kv.append(part)
        ks, vs = place.reshard_all(kv, [(), cache.seq_axes, cache.head_axes, ()],
                                   [stripe, stripe], [[1, S, n_kv, Dh]] * 2)
        o = offload.prefill_attention(q, ks, vs, q_offset=q_offset)
        x = x + place.reduce(cm.linear(o, p["wo"], n_in=2), tp.heads)
        x = _placed_ffn(cfg, place, tp, p, x)
    x = cm.rmsnorm(x, _placed_table(place, params, "final_norm"), cfg.norm_eps)
    last = x.index_select(1, (n_valid - 1).long())[:, 0]              # (1, D)
    cache.put_length(slot, q_offset + n_valid)
    return _placed_logits(cfg, place, tp, params, table, last), cache


def _lane_writes(valid: torch.Tensor, *index: torch.Tensor):
    """The places and the source rows of a scatter of one value per row,
    where only the rows ``valid`` write (their place lies on this lane).
    A row that does not write must not race one that does (CUDA leaves the
    winner of repeated places undefined), so it takes the place and the
    value of the first row that writes, and that write happens twice,
    alike; when no row writes, each rewrites what its own place holds.
    No host sync.  Returns ``(index..., source rows, whether the source
    writes)``."""
    first = valid.to(torch.int32).argmax()
    own = valid | ~valid.any()
    src = torch.where(own, torch.arange(valid.shape[0], device=valid.device), first)
    return (*(torch.where(own, i, i[first]) for i in index), src, valid[src])


def _pool_put(pool: torch.Tensor, places, new: torch.Tensor) -> None:
    """``pool[phys, :, off] = new[src]`` where the source writes, else what
    is there (:func:`_lane_writes`' ``places``), as bytes."""
    phys, off, src, writes = places
    view = ref.byte_view(pool)
    old = view[phys, :, off]
    new = ref.byte_view(new.to(pool.dtype))[src]
    view[phys, :, off] = torch.where(writes.view(-1, *(1,) * (new.dim() - 1)), new, old)


def _placed_paged(cfg, place: Placement, params, cache: ShardedPool, tokens: torch.Tensor,
                  past_table_to_null: bool = False):
    """:func:`paged_decode_step` on a mesh, up to the logits of this rank's
    rows: ``(logits (b, V), the axes the rows are split over)``.  q, k and
    v go to the pool's layout (every row, this rank's KV heads); the new
    K/V (quantized with their scales for an fp8/int8 pool: per (head,
    position) vector over head_dim, which no policy splits, so the scales
    are one device's) land only where this lane holds the append block
    and the offset in it (:func:`_lane_writes`); the attention runs on
    this lane's part of every row through its table
    (:meth:`ShardedPool.lane_tables`, built once a step on the device) and
    :func:`offload.placed_paged_decode_attention` merges the lanes.  With
    the host tier the hot window starts at each row's cold length and the
    cold window ``[0, cold_len)`` is read on this rank's share of the host
    tier through ``host_tables``; ``past_table_to_null`` sends an append
    past the table to null block 0 (the verify step's overshoot)."""
    B = tokens.shape[0]
    rows = _rows(place, B)
    a0, a1 = place.part(rows, B)
    lengths, tables = cache["lengths"], cache["block_tables"]
    bs, MB = cache.block_size, tables.shape[1]
    quant = _kv_dtype_name(cache["k"].dtype)
    pos = lengths.long()
    blk = pos // bs
    phys = tables[torch.arange(B, device=pos.device), blk.clamp(max=MB - 1)].long()
    if past_table_to_null:
        phys = torch.where(blk < MB, phys, 0)
    off = pos % bs
    (b0, b1), (p0, p1) = cache.blocks, cache.pos
    valid = (phys >= b0) & (phys < b1) & (off >= p0) & (off < p1)
    places = _lane_writes(valid, (phys - b0).clamp(0, b1 - b0 - 1),
                          (off - p0).clamp(0, p1 - p0 - 1))
    cold = None
    if "host_k" in cache:
        cold = cache.host_lane_tables(cache["host_tables"], cache["cold_lengths"])
    lane_tables, lane_lengths = cache.lane_tables(
        tables, lengths + 1, None if cold is None else cache["cold_lengths"])
    Dh = cache["k"].shape[-1]

    def write(l, k, v):
        for name, new in (("k", k), ("v", v)):
            if quant:
                new, sc = ref.kv_quantize(new, quant)
                _pool_put(cache[f"{name}_scale"][l], places, sc)
            _pool_put(cache[name][l], places, new)

    logits = _placed_decode_layers(
        cfg, place, params, tokens, rows, pos[a0:a1],
        lambda n: offload.pool_layout(cache, n, Dh, B), write,
        lambda l, q, compute: offload.placed_paged_decode_attention(
            cache, l, q, compute, lane_tables, lane_lengths, cold))
    lengths.add_(1)
    return logits, rows
