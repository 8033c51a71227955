"""Slot-level KV cache management for continuous batching.

Counterpart of ``repro.serving.kv_cache`` (``insert``, ``export_slot``,
``reset_slot``, ``kv_bytes``), and :func:`set_length`.  Cache leaves carry
the batch dim at axis 1 (stacked layers at axis 0), ``lengths`` at axis 0.
Updates are in place.  A placed model's
:class:`~repro_torch.core.offload.ShardedCache` holds this rank's rows
only: a slot's view, reset and length act on the rank that holds the slot.
"""
from __future__ import annotations

from typing import Any

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
    """Copy a single-sequence cache ``sub`` (batch size 1) into ``slot``."""
    _unsharded(cache, "insert")
    for k, v in cache.items():
        v.narrow(batch_axis(k), slot, 1).copy_(sub[k])
    return cache


def export_slot(cache: Pytree, slot: int) -> Pytree:
    """One slot's stripe as a batch-1 sub-cache, copied out (the inverse of
    :func:`insert`): the dense cache's migration payload.  It holds the
    slot's ``lengths`` entry, so ``insert`` on the destination restores
    both the K/V and the length."""
    _unsharded(cache, "export_slot")
    return {k: v.narrow(batch_axis(k), slot, 1).clone() for k, v in cache.items()}


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


def _unsharded(cache: Pytree, op: str) -> None:
    if isinstance(cache, ShardedCache):
        raise NotImplementedError(f"{op}: moving a slot of a placed cache (cluster migration) "
                                  "waits for per-replica meshes")
