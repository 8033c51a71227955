"""In-place device ops on the physical block pool and the per-slot state.

Counterpart of ``repro.serving.paged.device`` for every pool tier:
:func:`copy_block` (copy-on-write), :func:`write_prompt_block` /
:func:`read_block` (staging lane <-> pool, quantizing on the way into an
fp8/int8 pool and dequantizing on the way out), :func:`spill_block` /
:func:`rehydrate_block` (device pool <-> host tier, in storage dtype),
:func:`sync_slot` / :func:`sync_host_slot` (one block-table row, one
host-table row and cold length; whole on every rank of a placed pool),
migration's :func:`copy_blocks_out` / :func:`copy_blocks_in` (a
sequence's blocks gathered out of one pool and scattered into another, in
storage dtype; out of a placed pool whole, from every lane's
:func:`blocks_piece` in one collective, and into a placed pool by each
lane's share, so the two pools may be cut differently), and the async
engine's
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

from repro_torch.core.offload import ShardedPool
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
    their scale blocks when the pool is quantized).  On a placed pool each
    lane copies its heads and positions of the block; when another lane
    holds ``src``, its shard comes over the block axes (every rank of the
    group takes part; one collective)."""
    keys = _pool_keys(cache)
    if not isinstance(cache, ShardedPool):
        for key in keys:
            _copy(cache[key][:, dst], cache[key][:, src])
        return cache
    i_src, i_dst = cache.local_block(src), cache.local_block(dst)
    if cache.owner(src) == cache.owner(dst):
        if i_src is not None:
            for key in keys:
                _copy(cache[key][:, i_dst], cache[key][:, i_src])
        return cache
    blocks = [ref.byte_view(cache[key][:, i_src] if i_src is not None else
                            torch.zeros_like(cache[key][:, 0])) for key in keys]
    stacks = cache.place.stack_all(blocks, cache.block_axes)
    if i_dst is not None:
        for key, st in zip(keys, stacks):
            ref.byte_view(cache[key][:, i_dst]).copy_(st[cache.owner(src)])
    return cache


def _span(S: int, start: int, bs: int) -> int:
    """``dynamic_slice`` semantics: a start that would run past the end is
    clamped so the window stays in bounds."""
    return min(max(start, 0), S - bs)


def _block_size(cache: Pytree) -> int:
    return cache.block_size if isinstance(cache, ShardedPool) else cache["k"].shape[3]


def write_prompt_block(cache: Pytree, sub_cache: Pytree, phys: int, start: int,
                       lane: int = 0) -> Pytree:
    """Copy staging positions ``[start, start+block_size)`` of ``lane``
    into pool block ``phys``, transposed to heads-major; an fp8/int8 pool
    quantizes each (head, position) vector on the way in and takes its
    scales into the scale pool.  On a mesh this is the paper's hand-off of
    a finished block from the compute side to the HPU lanes: the staging
    cache holds this rank's tensor-parallel heads, the block moves to the
    pool's layout (gathered over the heads' axes where the pool splits its
    heads otherwise) and the lane that holds ``phys`` keeps its heads and
    positions of it."""
    bs = _block_size(cache)
    quant = _quant(cache)
    blks = []
    for key in ("k", "v"):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        blks.append(sub[:, lane, s0:s0 + bs].transpose(1, 2))  # (L, Hkv, bs, Dh)
    if isinstance(cache, ShardedPool):
        blks = _to_lanes(cache, sub_cache, blks)
        phys = cache.local_block(phys)
        if phys is None:
            return cache
    for key, blk in zip(("k", "v"), blks):
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
    fp8/int8 block is dequantized into the staging dtype.  On a mesh the
    block's shards are gathered back from the lanes (:func:`_from_lanes`)."""
    bs = _block_size(cache)
    quant = _quant(cache)
    i = cache.local_block(phys) if isinstance(cache, ShardedPool) else phys
    blks = []
    for key in ("k", "v"):
        dt = sub_cache[key].dtype
        if i is None:
            blk = torch.zeros(cache[key][:, 0].shape, dtype=dt, device=cache[key].device)
        elif quant:
            blk = ref.kv_dequantize(cache[key][:, i], cache[f"{key}_scale"][:, i], dt)
        else:
            blk = cache[key][:, i].to(dt)                       # (L, Hkv, bs, Dh)
        blks.append(blk)
    if isinstance(cache, ShardedPool):
        blks = _from_lanes(cache, sub_cache, phys, blks)
    for key, blk in zip(("k", "v"), blks):
        sub = sub_cache[key]
        s0 = _span(sub.shape[2], start, bs)
        sub[:, lane, s0:s0 + bs].copy_(blk.transpose(1, 2))
    return sub_cache


def _to_lanes(pool: ShardedPool, staging, blks: list[torch.Tensor]) -> list[torch.Tensor]:
    """K and V of one block ``(L, h, bs, Dh)`` from the staging cache's
    heads to this lane's heads and positions of the pool."""
    L, _, bs, Dh = blks[0].shape
    dst = [((), (0, L)), (pool.head_axes, pool.heads), (pool.pos_axes, pool.pos), ((), (0, Dh))]
    return pool.place.reshard_all(blks, [(), staging.head_axes, (), ()], [dst, dst],
                                  [[L, pool.n_kv, bs, Dh]] * 2)


def _from_holder(pool: ShardedPool, phys: int, blks: list[torch.Tensor]) -> list[torch.Tensor]:
    """Leaves of block ``phys`` as this lane holds them (zeros where another
    lane holds the block) as the holding lane holds them: taken from it over
    the block axes (one collective; every rank of the group takes part)."""
    if pool.place.split(pool.block_axes):
        return [st[pool.owner(phys)] for st in pool.place.stack_all(blks, pool.block_axes)]
    return blks


def _from_lanes(pool: ShardedPool, staging, phys: int,
                blks: list[torch.Tensor]) -> list[torch.Tensor]:
    """K and V of block ``phys`` as this lane holds them (or zeros, where
    another lane holds the block) back to every position and the staging
    cache's heads: taken from the holder over the block axes, then
    gathered over the heads' and positions' axes."""
    place = pool.place
    blks = _from_holder(pool, phys, blks)
    L, _, _, Dh = blks[0].shape
    dst = [((), (0, L)), (staging.head_axes, staging.heads), ((), (0, pool.block_size)),
           ((), (0, Dh))]
    return place.reshard_all(blks, [(), pool.head_axes, pool.pos_axes, ()], [dst, dst],
                             [[L, pool.n_kv, pool.block_size, Dh]] * 2)


def spill_block(cache: Pytree, dev: int, host: int) -> Pytree:
    """Apply a ``("spill", dev, host)`` directive: copy device block
    ``dev`` into host-tier block ``host`` (k, v, and their scales), in
    storage dtype — a quantized block moves as its bytes.  On a placed pool
    the block is taken from the lane that holds it (over the block axes,
    as :func:`read_block` takes one) and every rank writes its share of the
    host block: its heads and, where the host tier splits them, its
    positions (:func:`_to_host`)."""
    keys = _pool_keys(cache)
    if not isinstance(cache, ShardedPool):
        for key in keys:
            _copy(cache[f"host_{key}"][:, host], cache[key][:, dev])
        return cache
    i = cache.local_block(dev)
    blks = _from_holder(cache, dev, [ref.byte_view(cache[key][:, i] if i is not None
                                                   else torch.zeros_like(cache[key][:, 0]))
                                     for key in keys])
    for key, blk in zip(keys, _to_host(cache, blks, host=True)):
        ref.byte_view(cache[f"host_{key}"][:, host]).copy_(blk)
    return cache


def rehydrate_block(cache: Pytree, host: int, dev: int) -> Pytree:
    """Apply a ``("rehydrate", host, dev)`` directive: copy host-tier
    block ``host`` back into device block ``dev``, bit-exact.  On a placed
    pool only the lane that holds ``dev`` writes it, its heads and
    positions of the host block (gathered over the host tier's position
    axes where they differ from the pool's)."""
    keys = _pool_keys(cache)
    if not isinstance(cache, ShardedPool):
        for key in keys:
            _copy(cache[key][:, dev], cache[f"host_{key}"][:, host])
        return cache
    blks = _to_host(cache, [ref.byte_view(cache[f"host_{key}"][:, host]) for key in keys],
                    host=False)
    i = cache.local_block(dev)
    if i is not None:
        for key, blk in zip(keys, blks):
            ref.byte_view(cache[key][:, i]).copy_(blk)
    return cache


def _to_host(pool: ShardedPool, blks: list[torch.Tensor], host: bool) -> list[torch.Tensor]:
    """Leaves of one block (``(L, h, p, Dh)`` payload bytes, ``(L, h, p)``
    scales) from the device pool's cut of heads and positions to the host
    tier's (``host``), or back: every rank of a group takes part."""
    pool_cut = [(pool.head_axes, pool.heads), (pool.pos_axes, pool.pos)]
    host_cut = [(pool.head_axes, pool.heads), (pool.host_pos_axes, pool.host_pos)]
    src, dst = (pool_cut, host_cut) if host else (host_cut, pool_cut)
    L, Dh = blks[0].shape[0], blks[0].shape[-1]
    dsts = [[((), (0, L)), *dst, ((), (0, Dh))][:b.dim()] for b in blks]
    fulls = [[L, pool.n_kv, pool.block_size, Dh][:b.dim()] for b in blks]
    return pool.place.reshard_all(blks, [(), src[0][0], src[1][0], ()], dsts, fulls)


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
    order puts the gather after every step already issued.  A placed pool
    gives the whole blocks on every rank of its mesh: every lane's
    :func:`blocks_piece`, stacked over the mesh in one collective, put
    together by :func:`blocks_assemble`."""
    if isinstance(cache, ShardedPool):
        keys = _pool_keys(cache)
        stacks = cache.place.stack_mesh(blocks_piece(cache, ids))
        return blocks_assemble([[st[r] for st in stacks] for r in range(stacks[0].shape[0])],
                               ids, keys, [cache[k].dtype for k in keys], cache.n_kv,
                               cache.block_size)
    idx = _block_index(ids, cache["k"].device)
    return {key: _gather_blocks(cache[key], idx) for key in _pool_keys(cache)}


def blocks_piece(pool: ShardedPool, ids: list[int]) -> list[torch.Tensor]:
    """This lane's part of pool blocks ``ids``: per pool leaf (k, v and the
    scale pools) ``(L, n, h, p[, Dh])`` of this lane's heads and positions
    (the payload as bytes, zeros where another lane holds the block), then
    ``[b0, b1, h0, h1, p0, p1]``, the lane's ranges."""
    b0, b1 = pool.blocks
    out = []
    for key in _pool_keys(pool):
        leaf = ref.byte_view(pool[key])
        out.append(torch.stack([leaf[:, i - b0] if b0 <= i < b1 else torch.zeros_like(leaf[:, 0])
                                for i in ids], dim=1))
    out.append(torch.tensor([*pool.blocks, *pool.heads, *pool.pos], device=out[0].device))
    return out


def blocks_assemble(pieces: list[list[torch.Tensor]], ids: list[int], keys, dtypes,
                    n_kv: int, block_size: int) -> Pytree:
    """The whole blocks ``ids`` from every lane's :func:`blocks_piece`: each
    lane's part of the blocks it holds written at its heads and positions,
    in the pool's storage ``dtypes``."""
    out = {}
    for j, (key, dt) in enumerate(zip(keys, dtypes)):
        first = pieces[0][j]
        whole = first.new_zeros((*first.shape[:2], n_kv, block_size, *first.shape[4:]))
        for p in pieces:
            b0, b1, h0, h1, p0, p1 = (int(x) for x in p[-1].tolist())
            cols = [c for c, i in enumerate(ids) if b0 <= i < b1]
            if cols:
                whole[:, cols, h0:h1, p0:p1] = p[j][:, cols]
        out[key] = whole.view(dt)
    return out


def copy_blocks_in(cache: Pytree, payload: Pytree, src_sel: list[int],
                   dst_ids: list[int]) -> Pytree:
    """Scatter payload columns ``src_sel`` (positions in the exported block
    list) into pool blocks ``dst_ids``, in place.  The selection skips the
    positions the importer's own prefix cache already holds.  Storage dtype
    on both sides: a migration moves bytes, never values.  On a placed
    pool each lane writes its heads and positions of the blocks it holds
    from the whole payload (no collective)."""
    dev = cache["k"].device
    pairs = list(zip(src_sel, dst_ids))
    cut = (slice(None),) * 2
    if isinstance(cache, ShardedPool):
        pairs = [(j, cache.local_block(d)) for j, d in pairs if cache.local_block(d) is not None]
        cut += (slice(*cache.heads), slice(*cache.pos))
    for key in _pool_keys(cache):
        if payload[key].dtype != cache[key].dtype:
            raise ValueError(f"migration payload {key} is {payload[key].dtype}, the pool "
                             f"stores {cache[key].dtype}")
        if pairs:
            sel, idx = (_block_index([p[i] for p in pairs], dev) for i in (0, 1))
            _scatter_blocks(cache[key], payload[key][cut], sel, idx)
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
