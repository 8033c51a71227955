"""In-place device ops on the physical block pool and the per-slot state.

Counterpart of ``repro.serving.paged.device`` for the bf16/f32 pool:
:func:`copy_block` (copy-on-write), :func:`write_prompt_block` /
:func:`read_block` (staging lane <-> pool), :func:`sync_slot` (one
block-table row), and the async engine's :func:`feed_token` /
:func:`set_stop_id`.  The reference's donated ``jax.jit`` updates become
in-place tensor ops on one CUDA stream: stream order stands in for JAX's
data-flow ordering, so an update issued at dispatch lands after the
in-flight step.  Host data reaches the device only through pinned memory
with ``non_blocking=True`` (a pageable copy would synchronise the
stream).  The host-tier transfers and the quantised writers wait for
their slice.

The pool leaves are kernel-native, ``(layers, n_blocks, kv_heads,
block_size, head_dim)``; the staging cache is the dense ``(layers, lanes,
S, kv_heads, head_dim)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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


def copy_block(cache: Pytree, src: int, dst: int) -> Pytree:
    """COW: duplicate physical block ``src`` into ``dst`` (k and v)."""
    for key in ("k", "v"):
        cache[key][:, dst].copy_(cache[key][:, src])
    return cache


def _span(S: int, start: int, bs: int) -> int:
    """``dynamic_slice`` semantics: a start that would run past the end is
    clamped so the window stays in bounds."""
    return min(max(start, 0), S - bs)


def write_prompt_block(cache: Pytree, sub_cache: Pytree, phys: int, start: int,
                       lane: int = 0) -> Pytree:
    """Copy staging positions ``[start, start+block_size)`` of ``lane``
    into pool block ``phys``, transposed to heads-major."""
    bs = cache["k"].shape[3]
    for key in ("k", "v"):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        blk = sub[:, lane, s0:s0 + bs].transpose(1, 2)        # (L, Hkv, bs, Dh)
        cache[key][:, phys].copy_(blk)
    return cache


def read_block(sub_cache: Pytree, cache: Pytree, phys: int, start: int,
               lane: int = 0) -> Pytree:
    """Inverse of :func:`write_prompt_block`: hydrate staging ``lane`` at
    ``[start, start+block_size)`` from pool block ``phys`` (a prefix-cache
    hit), so chunked-prefill attention sees the shared prefix's K/V."""
    bs = cache["k"].shape[3]
    for key in ("k", "v"):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        sub[:, lane, s0:s0 + bs].copy_(cache[key][:, phys].transpose(1, 2))
    return sub_cache


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


def feed_token(tok_state: torch.Tensor, slot: int, token: torch.Tensor) -> torch.Tensor:
    """Async engine: one slot's next decode input, a (1,) device tensor (a
    prefill's first token never round-trips the host)."""
    tok_state[slot:slot + 1].copy_(token.reshape(1))
    return tok_state


def set_stop_id(eos_ids: torch.Tensor, slot: int, eos_id: int) -> torch.Tensor:
    """Refresh one slot's on-device stop id (-1 = never stops)."""
    eos_ids[slot] = eos_id
    return eos_ids
