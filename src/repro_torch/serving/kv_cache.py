"""Slot-level KV cache management for continuous batching.

Counterpart of ``repro.serving.kv_cache`` (``insert``, ``export_slot``,
``reset_slot``, ``kv_bytes``).  Cache leaves carry the batch dim at axis 1 (stacked
layers at axis 0), ``lengths`` at axis 0.  Updates are in place.
"""
from __future__ import annotations

from typing import Any

Pytree = Any


def batch_axis(key: str) -> int:
    return 0 if key == "lengths" else 1


def slot_view(cache: Pytree, slot: int) -> Pytree:
    """One slot's stripe as a batch-1 cache of *views*: writing into it
    (e.g. a prefill) writes into ``cache``."""
    return {k: v.narrow(batch_axis(k), slot, 1) for k, v in cache.items()}


def insert(cache: Pytree, sub: Pytree, slot: int) -> Pytree:
    """Copy a single-sequence cache ``sub`` (batch size 1) into ``slot``."""
    for k, v in cache.items():
        v.narrow(batch_axis(k), slot, 1).copy_(sub[k])
    return cache


def export_slot(cache: Pytree, slot: int) -> Pytree:
    """One slot's stripe as a batch-1 sub-cache, copied out (the inverse of
    :func:`insert`): the dense cache's migration payload.  It holds the
    slot's ``lengths`` entry, so ``insert`` on the destination restores
    both the K/V and the length."""
    return {k: v.narrow(batch_axis(k), slot, 1).clone() for k, v in cache.items()}


def reset_slot(cache: Pytree, slot: int) -> Pytree:
    """Zero a slot (length <- 0 frees it logically)."""
    for k, v in cache.items():
        v.narrow(batch_axis(k), slot, 1).zero_()
    return cache


def kv_bytes(cache: Pytree) -> int:
    return sum(v.numel() * v.element_size() for v in cache.values())
