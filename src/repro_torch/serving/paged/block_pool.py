"""Fixed-size KV block pool: free-list allocator, refcounts, prefix hashing.

A copy of ``repro.serving.paged.block_pool`` (host-side numpy-free
Python); the port keeps its own so that it imports nothing of ``repro``.

The paper's scaling argument (§VI) is that KV *capacity*, not compute,
bounds large-batch decode — so physical cache memory must be a fungible
pool, not per-slot reservations.  ``BlockPool`` manages the physical side
of that pool entirely on the host: device arrays never move; allocation
is bookkeeping over block ids.

Conventions
-----------
* Block id 0 is the **null/trash block**: it is never allocated, every
  unused block-table entry points at it, and inactive decode lanes write
  their (ignored) K/V there.  Usable capacity is ``n_blocks - 1``.
* A *full* block whose contents are a pure function of a token prefix is
  registered under a chain hash ``key_j = (key_{j-1}, tokens_j)`` so a
  later request with the same prefix reuses the physical block
  (vLLM-style prefix caching).  Partial tail blocks register too — they
  match only byte-identical prompts — and are invalidated the moment a
  sequence appends to them in place (contents diverge from the key).
* Shared blocks are copy-on-write: the *appending* sequence copies, the
  remaining owners keep the original (see ``PagedCacheManager``).

Host tier (``host_blocks > 0``)
-------------------------------
A second, host-memory pool of the same block granularity (host id 0 is
again the null block).  Two flows feed it:

* **free-time spill** — when a hash-registered device block's refcount
  hits 0, its contents spill to a host block instead of vanishing: the
  prefix stays re-hydratable (a later identical prompt copies it back
  device-ward instead of recomputing the prefill).  Host capacity is a
  victim cache: unreferenced host blocks are LRU-evicted to make room.
* **live spill** — ``PagedCacheManager.spill_live_prefix`` moves a live
  sequence's cold leading blocks host-ward under pool pressure
  (spill-before-evict), ref-holding the host block until the slot frees.

The pool never touches device arrays: every spill/rehydrate decision is
emitted as a ``("spill", dev, host)`` / ``("rehydrate", host, dev)``
directive on :attr:`directives`; the engine drains them into the actual
device<->host block copies (``serving/paged/device.py``) before any
subsequent pool write can clobber the source.

Migration (cross-replica handoff)
---------------------------------
:meth:`BlockPool.export_blocks` releases a departing sequence's blocks
refcount-aware: a sole-owner block frees outright, a shared block only
decrefs (the caller copies its contents out first — copy-on-export — so
remaining owners and the hash entry stay intact).  On the destination,
:meth:`BlockPool.import_blocks` allocates fresh blocks but dedups
against blocks already resident under the same chain-hash key (incref
instead of a device copy), so migrating a popular prefix twice costs
one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0          # fresh physical blocks handed out
    frees: int = 0           # blocks returned to the free list
    hash_hits: int = 0       # prefix-cache lookups that found a block
    cow_copies: int = 0      # copy-on-write block duplications
    preemptions: int = 0     # sequences evicted for block pressure
    peak_in_use: int = 0
    spills: int = 0          # device blocks copied host-ward (both flows)
    rehydrates: int = 0      # host blocks copied back device-ward
    host_evictions: int = 0  # cold host blocks dropped for host pressure
    host_peak_in_use: int = 0
    exports: int = 0         # blocks released to a migrating sequence
    imports: int = 0         # blocks landed from a migrating sequence
    import_dedup: int = 0    # import positions satisfied by a resident block


class BlockPool:
    def __init__(self, n_blocks: int, block_size: int, host_blocks: int = 0):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + null), got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list, low ids first out — keeps tests deterministic
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._key_to_block: dict[Hashable, int] = {}
        self._block_to_key: dict[int, Hashable] = {}
        self.stats = PoolStats()
        # ------------------------------------------------------- host tier
        self.host_blocks = host_blocks
        self._host_free = list(range(host_blocks, 0, -1))
        self._host_ref: dict[int, int] = {}
        self._key_to_host: dict[Hashable, int] = {}
        self._host_to_key: dict[int, Hashable] = {}
        self._host_lru: list[int] = []       # unreferenced host blocks, oldest first
        self.directives: list[tuple] = []    # pending device<->host copies

    # ------------------------------------------------------------- capacity
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        """Fraction of usable blocks currently owned — the cluster
        router's load signal for KV memory pressure."""
        return self.in_use / max(self.n_blocks - 1, 1)

    # ----------------------------------------------------------- allocation
    def alloc(self) -> int:
        """Take a free block (refcount 1).  Raises when the pool is dry —
        callers gate on ``free_count`` and preempt instead."""
        if not self._free:
            raise RuntimeError("BlockPool exhausted")
        b = self._free.pop()
        self._ref[b] = 1
        self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return b

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def incref(self, block: int) -> None:
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            key = self._block_to_key.get(block)
            if (self.host_blocks and key is not None
                    and key not in self._key_to_host):
                # free-time spill: keep the dying prefix re-hydratable
                hb = self._host_reserve()
                if hb is not None:
                    self.directives.append(("spill", block, hb))
                    self.host_register(key, hb)
                    self._host_lru.append(hb)
                    self.stats.spills += 1
            self.invalidate(block)
            self._free.append(block)
            self.stats.frees += 1

    # ------------------------------------------------------------ migration
    def export_blocks(self, ids: list[int]) -> list[bool]:
        """Release a migrating sequence's blocks from *this* pool after
        their contents were gathered device-side (``copy_blocks_out``).

        Refcount-aware: a shared-prefix block is **copy-on-export** — the
        peer replica copies the payload while the remaining owners here
        keep the physical block *and* its hash entry untouched (only this
        sequence's reference drops).  A privately-owned block frees
        through the normal :meth:`decref` path, so a hash-registered
        prefix still free-time-spills to the host tier: migrating a
        sequence away does not cold-start this replica's prefix cache.

        Returns per-block ``was_shared`` flags (diagnostics/tests).
        """
        shared = []
        for b in ids:
            if b == 0:
                # cold (live-spilled) marker — callers exclude these
                raise ValueError("cannot export a cold (host-resident) block")
            shared.append(self.refcount(b) > 1)
            self.decref(b)
        self.stats.exports += len(ids)
        return shared

    def import_blocks(
        self, keys: list
    ) -> tuple[list[int], list[bool]] | None:
        """Allocate landing blocks for a migrating sequence described by
        its per-block hash ``keys`` (None = unkeyed: diverged tail or
        decode headroom).

        A key already resident in *this* pool's prefix hash is reused
        (incref, no device copy — migration dedups against the
        destination's prefix cache; contents are identical by
        construction since the key is a chain hash of the whole token
        prefix).  Everything else allocates a fresh block, registered
        under its key so the migrated prefix is matchable here.

        Returns ``(block_ids, needs_copy)`` aligned with ``keys``, or
        ``None`` — nothing mutated — when the free list cannot supply the
        fresh blocks (the caller spills or declines the migration).
        """
        hits = [self.peek(k) if k is not None else None for k in keys]
        fresh = sum(1 for h in hits if h is None)
        if fresh > self.free_count:
            return None
        ids, needs = [], []
        for k, hit in zip(keys, hits):
            if hit is not None:
                self.incref(hit)
                ids.append(hit)
                needs.append(False)
                self.stats.import_dedup += 1
            else:
                b = self.alloc()
                if k is not None:
                    self.register(k, b)
                ids.append(b)
                needs.append(True)
        self.stats.imports += len(ids)
        return ids, needs

    # ------------------------------------------------------- prefix caching
    def lookup(self, key: Hashable) -> int | None:
        b = self._key_to_block.get(key)
        if b is not None:
            self.stats.hash_hits += 1
        return b

    def peek(self, key: Hashable) -> int | None:
        """Stat-free :meth:`lookup`: read-only probes (the cluster
        router's prefix-affinity scoring) must not count as cache hits."""
        return self._key_to_block.get(key)

    def register(self, key: Hashable, block: int) -> None:
        # a colliding re-register (identical content written twice) keeps
        # the newest mapping; both directions stay consistent
        old = self._key_to_block.get(key)
        if old is not None:
            self._block_to_key.pop(old, None)
        self._key_to_block[key] = block
        self._block_to_key[block] = key

    def invalidate(self, block: int) -> None:
        """Drop the hash entry for ``block`` (content changed or freed)."""
        key = self._block_to_key.pop(block, None)
        if key is not None:
            self._key_to_block.pop(key, None)

    # ------------------------------------------------------------ host tier
    @property
    def host_in_use(self) -> int:
        return self.host_blocks - len(self._host_free)

    @property
    def host_utilization(self) -> float:
        return self.host_in_use / max(self.host_blocks, 1)

    def _host_reserve(self) -> int | None:
        """Take a host block id, LRU-evicting an unreferenced cold host
        block under pressure.  None when every host block is ref-held."""
        if not self._host_free:
            if not self._host_lru:
                return None
            victim = self._host_lru.pop(0)
            self.host_invalidate(victim)
            self._host_free.append(victim)
            self.stats.host_evictions += 1
        hb = self._host_free.pop()
        self.stats.host_peak_in_use = max(
            self.stats.host_peak_in_use, self.host_in_use
        )
        return hb

    def host_alloc(self) -> int | None:
        """Take a ref-held host block (live spill).  None when the host
        tier is saturated with ref-held blocks."""
        hb = self._host_reserve()
        if hb is not None:
            self._host_ref[hb] = 1
        return hb

    def host_refcount(self, hb: int) -> int:
        return self._host_ref.get(hb, 0)

    def host_incref(self, hb: int) -> None:
        # a cold (unreferenced) host block becoming ref-held leaves the
        # LRU eviction candidate list
        if self._host_ref.get(hb, 0) == 0 and hb in self._host_lru:
            self._host_lru.remove(hb)
        self._host_ref[hb] = self._host_ref.get(hb, 0) + 1

    def host_decref(self, hb: int) -> None:
        self._host_ref[hb] -= 1
        if self._host_ref[hb] == 0:
            del self._host_ref[hb]
            if hb in self._host_to_key:
                # registered prefix: keep as an evictable cold cache entry
                self._host_lru.append(hb)
            else:
                self._host_free.append(hb)

    def host_lookup(self, key: Hashable) -> int | None:
        hb = self._key_to_host.get(key)
        if hb is not None:
            self.stats.hash_hits += 1
        return hb

    def host_peek(self, key: Hashable) -> int | None:
        """Stat-free :meth:`host_lookup` for read-only probes."""
        return self._key_to_host.get(key)

    def host_register(self, key: Hashable, hb: int) -> None:
        old = self._key_to_host.get(key)
        if old is not None:
            self._host_to_key.pop(old, None)
        self._key_to_host[key] = hb
        self._host_to_key[hb] = key

    def host_invalidate(self, hb: int) -> None:
        key = self._host_to_key.pop(hb, None)
        if key is not None:
            self._key_to_host.pop(key, None)

    def drain_directives(self) -> list[tuple]:
        """Hand the pending device<->host copy directives to the engine
        (cleared here; the engine must apply them before the next write
        to any involved device block)."""
        out, self.directives = self.directives, []
        return out


def chain_key(prev: Hashable, block_tokens: tuple[int, ...]) -> Hashable:
    """Prefix-chain hash key: identifies a block by the whole token prefix
    ending in it (tuple length distinguishes partial from full blocks)."""
    return (prev, block_tokens)
