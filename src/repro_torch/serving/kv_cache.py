"""Slot-level KV cache management for continuous batching.

Counterpart of ``repro.serving.kv_cache`` (``insert``, ``export_slot``,
``reset_slot``, ``kv_bytes``), and :func:`set_length`.  Cache leaves carry
the batch dim at axis 1 (stacked layers at axis 0), ``lengths`` at axis 0.
Updates are in place.  A placed model's
:class:`~repro_torch.core.offload.ShardedCache` holds this rank's rows
only: a slot's view, reset and length act on the rank that holds the slot.
A slot migrates whole: :func:`export_slot` gathers it from the ranks that
hold its positions and heads (:func:`slot_piece` on each, one collective
over the mesh, :func:`slot_assemble`) and :func:`insert` writes each
rank's part of a whole slot, so source and destination may be cut
differently.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.offload import ShardedCache, ShardedPool

Pytree = Any


def batch_axis(key: str) -> int:
    return 0 if key == "lengths" else 1


def slot_view(cache: Pytree, slot: int) -> Pytree:
    """One slot's stripe as a batch-1 cache of *views*: writing into it
    (e.g. a prefill) writes into ``cache``."""
    if isinstance(cache, ShardedCache):
        return cache.slot_view(slot)
    return {k: v.narrow(batch_axis(k), slot, 1) for k, v in cache.items()}


def insert(cache: Pytree, sub: Pytree, slot: int) -> Pytree:
    """Copy a single-sequence cache ``sub`` (batch size 1, whole) into
    ``slot``; on a placed cache the rank that holds the slot writes its
    positions and heads of it."""
    if isinstance(cache, ShardedCache):
        slot = cache.local_row(slot)
        if slot is None:                # another rank holds it
            return cache
        (s0, s1), (h0, h1) = cache.seq, cache.heads
        sub = {k: v if k == "lengths" else v[:, :, s0:s1, h0:h1] for k, v in sub.items()}
    for k, v in cache.items():
        v.narrow(batch_axis(k), slot, 1).copy_(sub[k])
    return cache


def export_slot(cache: Pytree, slot: int) -> Pytree:
    """One slot's stripe as a batch-1 sub-cache, copied out (the inverse of
    :func:`insert`): the dense cache's migration payload.  It holds the
    slot's ``lengths`` entry, so ``insert`` on the destination restores
    both the K/V and the length.  A placed cache's slot is gathered whole
    on every rank of its mesh (one collective)."""
    if isinstance(cache, ShardedCache):
        keys = list(cache)
        stacks = cache.place.stack_mesh(slot_piece(cache, slot))
        return slot_assemble([[st[r] for st in stacks] for r in range(stacks[0].shape[0])],
                             keys, cache.max_seq, cache.n_kv)
    return {k: v.narrow(batch_axis(k), slot, 1).clone() for k, v in cache.items()}


def slot_piece(cache: ShardedCache, slot: int) -> list[torch.Tensor]:
    """This rank's part of ``slot``: per leaf, in the cache's order, its
    row of this rank's positions and heads (zeros where another rank holds
    the row; ``lengths`` ``(1,)``), then ``[held, s0, s1, h0, h1]``."""
    i = cache.local_row(slot)
    out = [v.narrow(batch_axis(k), 0 if i is None else i, 1).clone() for k, v in cache.items()]
    if i is None:
        out = [t.zero_() for t in out]
    out.append(torch.tensor([i is not None, *cache.seq, *cache.heads], device=out[0].device))
    return out


def slot_assemble(pieces: list[list[torch.Tensor]], keys: list[str], max_seq: int,
                  n_kv: int) -> Pytree:
    """The whole slot from every rank's :func:`slot_piece` (``keys`` the
    cache's leaves in order): each held part written at its positions and
    heads, the length from a rank that holds the row."""
    out = {}
    for j, key in enumerate(keys):
        first = pieces[0][j]
        whole = first.new_zeros((*first.shape[:2], max_seq, n_kv, *first.shape[4:])
                                if key != "lengths" else first.shape)
        for p in pieces:
            held, s0, s1, h0, h1 = (int(x) for x in p[-1].tolist())
            if held:
                if key == "lengths":
                    whole.copy_(p[j])
                else:
                    whole[:, :, s0:s1, h0:h1] = p[j]
        out[key] = whole
    return out


def reset_slot(cache: Pytree, slot: int) -> Pytree:
    """Zero a slot (length <- 0 frees it logically)."""
    if isinstance(cache, ShardedCache):
        slot = cache.local_row(slot)
        if slot is None:                # another rank holds it
            return cache
    for k, v in cache.items():
        v.narrow(batch_axis(k), slot, 1).zero_()
    return cache


def set_length(cache: Pytree, slot, value) -> Pytree:
    """``lengths[slot] = value``, ``slot`` and ``value`` ``(1,)`` device
    tensors, with no host sync (on a placed cache, by the rank that holds
    the slot)."""
    if isinstance(cache, ShardedCache):
        cache.put_length(slot, value)
    else:
        cache["lengths"].index_put_((slot.long(),), value)
    return cache


def kv_bytes(cache: Pytree) -> int:
    """The cache's bytes; a placed pool's whole, what one device holds."""
    if isinstance(cache, ShardedPool):
        return cache.nbytes
    return sum(v.numel() * v.element_size() for v in cache.values())

