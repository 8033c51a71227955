"""Paged KV cache: the host-side block pool and per-slot tables (copies
of ``repro.serving.paged.block_pool`` and ``manager``) and the in-place
device ops on the pool (``device``)."""
from repro_torch.serving.paged import device
from repro_torch.serving.paged.block_pool import BlockPool, PoolStats, chain_key
from repro_torch.serving.paged.manager import PagedCacheManager

__all__ = ["BlockPool", "PoolStats", "chain_key", "PagedCacheManager", "device"]
