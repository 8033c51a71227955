"""In-place device ops on the physical block pool and the per-slot state.

Counterpart of ``repro.serving.paged.device`` for every pool tier:
:func:`copy_block` (copy-on-write), :func:`write_prompt_block` /
:func:`read_block` (staging lane <-> pool, quantizing on the way into an
fp8/int8 pool and dequantizing on the way out), :func:`spill_block` /
:func:`rehydrate_block` (device pool <-> host tier, in storage dtype),
:func:`sync_slot` / :func:`sync_host_slot` (one block-table row, one
host-table row and cold length), migration's :func:`copy_blocks_out` /
:func:`copy_blocks_in` (a sequence's blocks gathered out of one pool and
scattered into another, in storage dtype), and the async engine's
:func:`feed_token` / :func:`set_stop_id`.

The reference's donated ``jax.jit`` updates become in-place tensor ops on
one CUDA stream: stream order stands in for JAX's data-flow ordering, so
an update issued at dispatch lands after the in-flight step.  Host data
reaches the device only through pinned memory with ``non_blocking=True``
(a pageable copy would synchronise the stream), from a copy taken first,
so the caller may rewrite its row at once.

The pool leaves are kernel-native, ``(layers, n_blocks, kv_heads,
block_size, head_dim)``, with scale pools ``(layers, n_blocks, kv_heads,
block_size)`` f32 when quantized; the staging cache is the dense
``(layers, lanes, S, kv_heads, head_dim)`` in full precision.  The host
tier's leaves (``host_k``, ...) have the pool's layout and live on the
pool's device, as the reference's do.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ref

Pytree = Any


def host_copy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` that the caller may mutate right after; pinned when
    it is bound for a CUDA device (the caching host allocator keeps it
    until the transfer has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t.clone()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting on the device."""
    return host_copy(a, device).to(device, non_blocking=True)


def _quant(cache: Pytree) -> str | None:
    """The pool's quantization name ("fp8"/"int8"), None for a bf16/f32
    pool (one without scale pools)."""
    if "k_scale" not in cache:
        return None
    return "int8" if cache["k"].dtype == torch.int8 else "fp8"


def _pool_keys(cache: Pytree) -> tuple[str, ...]:
    """The pool leaves a whole-block copy moves: k and v, and their scale
    pools when the pool is quantized."""
    return ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else ("k", "v")


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Same-dtype block copy, byte for byte."""
    ref.byte_view(dst).copy_(ref.byte_view(src))


def copy_block(cache: Pytree, src: int, dst: int) -> Pytree:
    """COW: duplicate physical block ``src`` into ``dst`` (k and v, and
    their scale blocks when the pool is quantized)."""
    for key in _pool_keys(cache):
        _copy(cache[key][:, dst], cache[key][:, src])
    return cache


def _span(S: int, start: int, bs: int) -> int:
    """``dynamic_slice`` semantics: a start that would run past the end is
    clamped so the window stays in bounds."""
    return min(max(start, 0), S - bs)


def write_prompt_block(cache: Pytree, sub_cache: Pytree, phys: int, start: int,
                       lane: int = 0) -> Pytree:
    """Copy staging positions ``[start, start+block_size)`` of ``lane``
    into pool block ``phys``, transposed to heads-major; an fp8/int8 pool
    quantizes each (head, position) vector on the way in and takes its
    scales into the scale pool."""
    bs = cache["k"].shape[3]
    quant = _quant(cache)
    for key in ("k", "v"):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        blk = sub[:, lane, s0:s0 + bs].transpose(1, 2)        # (L, Hkv, bs, Dh)
        if quant:
            payload, scale = ref.kv_quantize(blk, quant)
            _copy(cache[key][:, phys], payload)
            cache[f"{key}_scale"][:, phys].copy_(scale)
        else:
            cache[key][:, phys].copy_(blk)
    return cache


def read_block(sub_cache: Pytree, cache: Pytree, phys: int, start: int,
               lane: int = 0) -> Pytree:
    """Inverse of :func:`write_prompt_block`: hydrate staging ``lane`` at
    ``[start, start+block_size)`` from pool block ``phys`` (a prefix-cache
    hit), so chunked-prefill attention sees the shared prefix's K/V; an
    fp8/int8 block is dequantized into the staging dtype."""
    bs = cache["k"].shape[3]
    quant = _quant(cache)
    for key in ("k", "v"):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        blk = cache[key][:, phys]                               # (L, Hkv, bs, Dh)
        if quant:
            blk = ref.kv_dequantize(blk, cache[f"{key}_scale"][:, phys], sub.dtype)
        sub[:, lane, s0:s0 + bs].copy_(blk.transpose(1, 2))
    return sub_cache


def spill_block(cache: Pytree, dev: int, host: int) -> Pytree:
    """Apply a ``("spill", dev, host)`` directive: copy device block
    ``dev`` into host-tier block ``host`` (k, v, and their scales), in
    storage dtype — a quantized block moves as its bytes."""
    for key in _pool_keys(cache):
        _copy(cache[f"host_{key}"][:, host], cache[key][:, dev])
    return cache


def rehydrate_block(cache: Pytree, host: int, dev: int) -> Pytree:
    """Apply a ``("rehydrate", host, dev)`` directive: copy host-tier
    block ``host`` back into device block ``dev``, bit-exact."""
    for key in _pool_keys(cache):
        _copy(cache[key][:, dev], cache[f"host_{key}"][:, host])
    return cache


def _block_index(ids, device: torch.device) -> torch.Tensor:
    return to_device(np.asarray(ids, np.int64), device)


def _gather_blocks(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``pool[:, ids]`` as a new tensor, moved as bytes (:func:`ref.byte_view`)."""
    return ref.byte_view(pool).index_select(1, ids).view(pool.dtype)


def _scatter_blocks(pool: torch.Tensor, payload: torch.Tensor, src_sel: torch.Tensor,
                    dst_ids: torch.Tensor) -> None:
    """``pool[:, dst_ids] = payload[:, src_sel]`` in place, as bytes."""
    ref.byte_view(pool).index_copy_(1, dst_ids, ref.byte_view(payload).index_select(1, src_sel))


def copy_blocks_out(cache: Pytree, ids: list[int]) -> Pytree:
    """Gather a migrating sequence's physical blocks out of the pool in
    **storage dtype**: a quantized pool exports its int8/fp8 bytes and the
    matching scale-pool tiles, so a migration between pools of one
    ``kv_dtype`` is bit exact.  Returns ``{"k": (L, n, Hkv, bs, Dh), ...}``,
    new tensors: the source keeps stepping after the export, and stream
    order puts the gather after every step already issued."""
    idx = _block_index(ids, cache["k"].device)
    return {key: _gather_blocks(cache[key], idx) for key in _pool_keys(cache)}


def copy_blocks_in(cache: Pytree, payload: Pytree, src_sel: list[int],
                   dst_ids: list[int]) -> Pytree:
    """Scatter payload columns ``src_sel`` (positions in the exported block
    list) into pool blocks ``dst_ids``, in place.  The selection skips the
    positions the importer's own prefix cache already holds.  Storage dtype
    on both sides: a migration moves bytes, never values."""
    dev = cache["k"].device
    sel, idx = _block_index(src_sel, dev), _block_index(dst_ids, dev)
    for key in _pool_keys(cache):
        if payload[key].dtype != cache[key].dtype:
            raise ValueError(f"migration payload {key} is {payload[key].dtype}, the pool "
                             f"stores {cache[key].dtype}")
        _scatter_blocks(cache[key], payload[key], sel, idx)
    return cache


def sync_slot(cache: Pytree, slot: int, row: np.ndarray,
              length: int | None = None) -> Pytree:
    """Push one host block-table row (and optionally the slot length) to
    the device cache."""
    tables = cache["block_tables"]
    tables[slot].copy_(host_copy(np.asarray(row, np.int32), tables.device),
                       non_blocking=True)
    if length is not None:
        cache["lengths"][slot] = length
    return cache


def sync_host_slot(cache: Pytree, slot: int, row: np.ndarray, cold_len: int) -> Pytree:
    """Push one slot's host block-table row and cold-prefix length (the
    start of its hot attention window) to the device cache.  The row is
    copied before its non-blocking push (:func:`host_copy`), so the
    manager may rewrite it at once."""
    tables = cache["host_tables"]
    tables[slot].copy_(host_copy(np.asarray(row, np.int32), tables.device),
                       non_blocking=True)
    cache["cold_lengths"][slot] = cold_len
    return cache


def feed_token(tok_state: torch.Tensor, slot: int | torch.Tensor, token: torch.Tensor | int,
               when: torch.Tensor | None = None) -> torch.Tensor:
    """Async engine: one slot's next decode input, a (1,) device tensor (a
    prefill's first token never round-trips the host) or a host int (a
    migrated request's last sampled token, written unconditionally).
    ``slot`` is a host int or a ``(1,)`` int32 device tensor (a captured
    program's scalar); ``when``, a ``(1,)`` device flag, splices a tensor
    token only where it is nonzero (the reference's ``jnp.where(last,
    ...)``).  No host sync."""
    if not isinstance(token, torch.Tensor):
        tok_state[slot] = token
        return tok_state
    tok = token.reshape(1).to(tok_state.dtype)
    idx = slot.reshape(1).long() if isinstance(slot, torch.Tensor) else None
    if when is not None:
        cur = tok_state[slot:slot + 1] if idx is None else tok_state.index_select(0, idx)
        tok = torch.where(when.reshape(1) != 0, tok, cur)
    if idx is None:
        tok_state[slot:slot + 1].copy_(tok)
    else:
        tok_state.index_copy_(0, idx, tok)
    return tok_state


def set_stop_id(eos_ids: torch.Tensor, slot: int, eos_id: int) -> torch.Tensor:
    """Refresh one slot's on-device stop id (-1 = never stops)."""
    eos_ids[slot] = eos_id
    return eos_ids
