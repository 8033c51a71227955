"""Per-slot block tables over a shared :class:`BlockPool`.

A copy of ``repro.serving.paged.manager`` (host-side, numpy only); the
port keeps its own so that it imports nothing of ``repro``.

Host-side logical bookkeeping for the paged cache: which physical blocks
each serving slot owns, in prompt order.  Device arrays (the block pool
itself and the int32 ``block_tables`` the kernels read) are owned by the
engine; the manager only decides ids and hands the engine directives
("copy block a->b", "table row changed").

Admission (``try_admit``) walks the prompt block-by-block through the
pool's prefix hash: matched blocks are shared (incref, no KV write);
the rest are freshly allocated and must be filled from the prefill
pass.  Decode-time appends (``ensure_append``) allocate a block at each
block boundary and copy-on-write a shared tail on the first divergent
append.

With a host tier (``pool.host_blocks > 0``) the matching walks extend to
the pool's *host* prefix hash: a host-resident block re-hydrates into a
fresh device block (a ``("rehydrate", host, dev)`` directive the engine
turns into a device copy) and counts as cached — the prefill compute is
saved even though the device block is new.  Under pool pressure
:meth:`spill_live_prefix` moves a live slot's cold leading blocks the
other way (spill-before-evict): the slot keeps decoding hybrid —
device kernel over its hot window, host path over the spilled prefix —
instead of being preempted and re-prefilled.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.paged.block_pool import BlockPool, chain_key


class PagedCacheManager:
    def __init__(self, pool: BlockPool, n_slots: int, max_blocks: int):
        self.pool = pool
        self.n_slots = n_slots
        self.max_blocks = max_blocks
        self.tables = np.zeros((n_slots, max_blocks), np.int32)
        self.blocks: list[list[int]] = [[] for _ in range(n_slots)]
        # hash key backing each owned block (None once content diverges)
        self.keys: list[list] = [[] for _ in range(n_slots)]
        self.admit_seq = [-1] * n_slots   # admission order; max = youngest
        self._counter = 0
        # prompt-wide key chain for a chunked admission in progress
        self._chunk_keys: dict[int, list] = {}
        # host tier: per-slot cold prefix (leading blocks live-spilled to
        # host memory).  host_tables[s, :cold] holds the host block ids;
        # blocks[s][j] == 0 marks a cold position; host_ids[s] are the
        # ref-held host blocks to release at teardown.
        self.host_tables = np.zeros((n_slots, max_blocks), np.int32)
        self.host_ids: list[list[int]] = [[] for _ in range(n_slots)]
        self.cold_blocks = [0] * n_slots

    def cold_len(self, slot: int) -> int:
        """Tokens of ``slot``'s prefix resident on the host tier (the hot
        attention window starts here)."""
        return self.cold_blocks[slot] * self.pool.block_size

    # ------------------------------------------------------------ admission
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool.block_size)

    # ------------------------------------------------------ read-only probes
    def _probe_walk(self, tokens: np.ndarray) -> tuple[int, int]:
        """Stat-free matching walk: ``(device_hits, total_hits)`` in
        blocks, where total includes host-tier hits (re-hydratable: the
        prefill compute is saved, but a fresh device block is still
        consumed)."""
        bs = self.pool.block_size
        need = self.blocks_for(len(tokens))
        key, dev, total = None, 0, 0
        for j in range(need):
            key = chain_key(key, tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]))
            if self.pool.peek(key) is not None:
                dev += 1
                total += 1
            elif self.pool.host_blocks and self.pool.host_peek(key) is not None:
                total += 1
            else:
                break
        return dev, total

    def probe_prefix(self, tokens: np.ndarray) -> int:
        """Longest prefix of ``tokens`` already resident in the pool's
        prefix hash (either tier), in tokens.  Side-effect free: no
        increfs, no allocation, no stats — the cluster router calls this
        on every replica per request to score prefix affinity, and a
        probe must not perturb the replica it does not choose."""
        _, total = self._probe_walk(tokens)
        return min(len(tokens), total * self.pool.block_size)

    def admit_shortfall(self, tokens: np.ndarray) -> int:
        """Fresh blocks an admission of ``tokens`` would allocate right
        now: total blocks minus *device*-resident prefix hits (a host hit
        saves the prefill but still needs a device block to re-hydrate
        into), plus the decode boundary headroom block when the prompt
        exactly fills its blocks.  Read-only (mirrors :meth:`try_admit`'s
        capacity check without mutating anything) — the admission probe
        behind ``Engine.can_admit``."""
        bs = self.pool.block_size
        need = self.blocks_for(len(tokens))
        dev, _ = self._probe_walk(tokens)
        headroom = 1 if (len(tokens) % bs == 0 and need < self.max_blocks) else 0
        return need - dev + headroom

    def try_admit(self, slot: int, tokens: np.ndarray):
        """Reserve blocks for ``tokens`` in ``slot``.

        Returns ``(block_ids, n_cached)`` — the first ``n_cached`` blocks
        were prefix-cache hits and already hold valid KV — or ``None``
        when the pool cannot supply the fresh blocks (caller waits or
        preempts).  Nothing is mutated on the ``None`` path.
        """
        bs = self.pool.block_size
        need = self.blocks_for(len(tokens))
        if need > self.max_blocks:
            raise ValueError(f"{len(tokens)} tokens > {self.max_blocks} blocks/seq")
        toks = [tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]) for j in range(need)]

        # matched walk over both tiers: (key, device block | None, host
        # block | None).  A host hit re-hydrates into a fresh device
        # block, so only device hits reduce the fresh-block bill.
        matched: list[tuple[object, int | None, int | None]] = []
        key = None
        for j in range(need):
            key = chain_key(key, toks[j])
            b = self.pool.lookup(key)
            if b is not None:
                matched.append((key, b, None))
                continue
            hb = self.pool.host_lookup(key) if self.pool.host_blocks else None
            if hb is None:
                break
            matched.append((key, None, hb))
        n_dev = sum(1 for _, b, _ in matched if b is not None)
        # when the prompt exactly fills its blocks the very first decode
        # append needs a fresh block — reserve it now (not merely check),
        # or a later admission can consume it and the new sequence gets
        # preempted in the same step its prefill just ran
        headroom = 1 if (len(tokens) % bs == 0 and need < self.max_blocks) else 0
        if need - n_dev + headroom > self.pool.free_count:
            return None

        ids, keys = [], []
        for k, b, hb in matched:
            if b is not None:
                self.pool.incref(b)
            else:
                # re-hydrate: fresh device block, KV copied back from host
                b = self.pool.alloc()
                self.pool.directives.append(("rehydrate", hb, b))
                self.pool.register(k, b)
                self.pool.stats.rehydrates += 1
            ids.append(b)
            keys.append(k)
        key = matched[-1][0] if matched else None
        for j in range(len(matched), need):
            key = chain_key(key, toks[j])
            b = self.pool.alloc()
            self.pool.register(key, b)
            ids.append(b)
            keys.append(key)
        if headroom:
            # decode-only block: owned, mapped, but no prompt KV to write
            # and never hash-registered
            ids.append(self.pool.alloc())
            keys.append(None)

        self.blocks[slot] = ids
        self.keys[slot] = keys
        self.tables[slot, :] = 0
        self.tables[slot, :len(ids)] = ids
        self.admit_seq[slot] = self._counter
        self._counter += 1
        # prompt blocks only (copy: the internal list mutates later) —
        # the caller fills blocks[n_cached:need] from the prefill pass
        return list(ids[:need]), len(matched)

    # -------------------------------------------- chunked (partial) admission
    def begin_chunked(self, slot: int, tokens: np.ndarray) -> list[int]:
        """Start a chunked admission: share the prefix-cache hit blocks
        only (increfs, no allocation — cannot fail for lack of blocks);
        fresh blocks are acquired chunk-by-chunk via
        :meth:`extend_chunked`.  Returns the matched physical block ids
        (their KV is already valid and must be copied into the prefill
        staging cache)."""
        bs = self.pool.block_size
        need = self.blocks_for(len(tokens))
        if need > self.max_blocks:
            raise ValueError(f"{len(tokens)} tokens > {self.max_blocks} blocks/seq")
        toks = [tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]) for j in range(need)]
        chain, key = [], None
        for j in range(need):
            key = chain_key(key, toks[j])
            chain.append(key)

        matched: list[int] = []
        for j in range(need):
            b = self.pool.lookup(chain[j])
            if b is not None:
                self.pool.incref(b)
            else:
                # host-tier hit: re-hydrate when a free device block is
                # available now; otherwise stop the walk (shorter prefix
                # hit — begin_chunked must stay unable to fail)
                hb = self.pool.host_lookup(chain[j]) if self.pool.host_blocks else None
                if hb is None or self.pool.free_count == 0:
                    break
                b = self.pool.alloc()   # refcount 1, no incref needed
                self.pool.directives.append(("rehydrate", hb, b))
                self.pool.register(chain[j], b)
                self.pool.stats.rehydrates += 1
            matched.append(b)

        self.blocks[slot] = list(matched)
        self.keys[slot] = chain[:len(matched)]
        self.tables[slot, :] = 0
        self.tables[slot, :len(matched)] = matched
        self.admit_seq[slot] = self._counter
        self._counter += 1
        self._chunk_keys[slot] = chain
        return matched

    def extend_chunked(self, slot: int, n_prompt: int, end: int, final: bool) -> bool:
        """Acquire the fresh blocks one chunk needs: enough to cover
        prompt positions ``< end``, plus the decode boundary block when
        the *final* chunk exactly fills its blocks (the headroom
        reservation, deferred from admission to the last chunk).  Returns
        False (side-effect free) when the pool cannot supply them now —
        the chunk stalls and is retried while decode keeps running."""
        bs = self.pool.block_size
        chain = self._chunk_keys[slot]
        have = len(self.blocks[slot])
        need = self.blocks_for(end)
        headroom = 1 if (
            final and n_prompt % bs == 0 and self.blocks_for(n_prompt) < self.max_blocks
        ) else 0
        fresh = max(0, need - have) + headroom
        if fresh > self.pool.free_count:
            return False
        for j in range(have, need):
            b = self.pool.alloc()
            self.pool.register(chain[j], b)
            self.blocks[slot].append(b)
            self.keys[slot].append(chain[j])
            self.tables[slot, j] = b
        if headroom:
            # decode-only block: owned, mapped, never hash-registered
            b = self.pool.alloc()
            self.blocks[slot].append(b)
            self.keys[slot].append(None)
            self.tables[slot, len(self.blocks[slot]) - 1] = b
        if final:
            self._chunk_keys.pop(slot, None)
        return True

    # ------------------------------------------------------------ live spill
    def spill_live_prefix(self, slot: int, length: int) -> bool:
        """Spill ``slot``'s oldest hot block to the host tier, freeing one
        device block without preempting the sequence (spill-before-evict).

        ``length`` is the slot's current KV length.  Only a *full* block
        strictly below the append block qualifies (the hot attention
        window must keep covering the append position), and only a
        privately-owned one (a shared block is attended hot by its other
        owners, who cannot follow it to the host tier).  Returns False
        when no block qualifies or the host tier is saturated — the
        caller falls back to preemption.
        """
        bs = self.pool.block_size
        j = self.cold_blocks[slot]
        if j >= length // bs or j >= len(self.blocks[slot]):
            return False
        b = self.blocks[slot][j]
        if self.pool.refcount(b) != 1:
            return False
        hb = self.pool.host_alloc()
        if hb is None:
            return False
        key = self.keys[slot][j]
        self.pool.directives.append(("spill", b, hb))
        if key is not None and self.pool.host_peek(key) is None:
            # the prefix stays matchable for future prompts, now host-side
            self.pool.host_register(key, hb)
        # drop the device hash entry *before* decref so the free path
        # does not auto-spill a second copy
        self.pool.invalidate(b)
        self.pool.decref(b)   # privately owned: frees the device block
        self.pool.stats.spills += 1
        self.blocks[slot][j] = 0
        self.keys[slot][j] = None
        self.tables[slot, j] = 0
        self.host_tables[slot, j] = hb
        self.host_ids[slot].append(hb)
        self.cold_blocks[slot] = j + 1
        return True

    # --------------------------------------------------------------- decode
    def ensure_append(self, slot: int, length: int):
        """Make position ``length`` of ``slot`` writable before a decode
        step appends there.

        Returns one of::

            ("ready", None)        tail block private, in-place append ok
            ("new",   block)       fresh block mapped at the boundary
            ("cow",   (src, dst))  shared tail duplicated; engine must
                                   device-copy src -> dst
            ("oom",   None)        pool dry; caller preempts and retries
        """
        bs = self.pool.block_size
        idx, off = length // bs, length % bs
        if off == 0:
            if idx < len(self.blocks[slot]):
                # boundary block already reserved at admission (exact-
                # multiple prompt): private, empty, nothing to invalidate
                return ("ready", None)
            if self.pool.free_count == 0:
                return ("oom", None)
            b = self.pool.alloc()
            self.blocks[slot].append(b)
            self.keys[slot].append(None)
            self.tables[slot, idx] = b
            return ("new", b)
        tail = self.blocks[slot][idx]
        if self.pool.refcount(tail) > 1:
            if self.pool.free_count == 0:
                return ("oom", None)
            dst = self.pool.alloc()
            self.pool.decref(tail)   # remaining owners keep the original
            self.blocks[slot][idx] = dst
            self.keys[slot][idx] = None
            self.tables[slot, idx] = dst
            self.pool.stats.cow_copies += 1
            return ("cow", (tail, dst))
        # private tail: appending mutates content, so its hash entry
        # (keyed to the old prefix) must not match future prompts
        self.pool.invalidate(tail)
        self.keys[slot][idx] = None
        return ("ready", None)

    # ------------------------------------------------------------- migration
    def export_slot(self, slot: int) -> tuple[list[int], list]:
        """Detach ``slot``'s blocks for migration to a peer replica.

        Returns ``(block_ids, keys)`` — the physical ids to gather
        (``device.copy_blocks_out``) and the hash-key chain describing
        them (the import ticket; None entries are diverged tails or
        decode headroom).  The blocks are released pool-side via
        :meth:`BlockPool.export_blocks` (shared-prefix blocks stay with
        their remaining owners — copy-on-export), and the slot's
        bookkeeping resets without the decrefs :meth:`free_slot` would
        double-apply.  Callers must reject slots with a cold (host-tier)
        prefix first: only device-resident sequences migrate.
        """
        if self.cold_blocks[slot]:
            raise ValueError(f"slot {slot} has a cold host-tier prefix")
        ids = list(self.blocks[slot])
        keys = list(self.keys[slot])
        self.pool.export_blocks(ids)
        self.blocks[slot] = []
        self.keys[slot] = []
        self.tables[slot, :] = 0
        self.admit_seq[slot] = -1
        self._chunk_keys.pop(slot, None)
        return ids, keys

    def import_shortfall(self, keys: list, length: int) -> int:
        """Fresh blocks an import of ``(keys, length)`` would allocate
        right now (read-only mirror of :meth:`import_slot`'s capacity
        check, including the decode-boundary headroom block)."""
        keys = self._with_headroom(keys, length)
        return sum(1 for k in keys if k is None or self.pool.peek(k) is None)

    def _with_headroom(self, keys: list, length: int) -> list:
        """Append the decode-boundary headroom key when the migrated KV
        exactly fills its blocks and no block covers the append position —
        mirroring ``try_admit``'s reservation so the destination's first
        decode append never lands on a dry pool."""
        bs = self.pool.block_size
        keys = list(keys)
        if (length % bs == 0 and len(keys) == length // bs
                and len(keys) < self.max_blocks):
            keys.append(None)
        return keys

    def import_slot(
        self, slot: int, keys: list, length: int
    ) -> tuple[list[int], list[bool]] | None:
        """Land a migrating sequence in ``slot``: allocate/dedup blocks
        for its key chain (:meth:`BlockPool.import_blocks`), reserve the
        decode-boundary headroom block when needed, and install the block
        table.  Returns ``(block_ids, needs_copy)`` aligned with the
        *original* ``keys`` plus any trailing headroom block (headroom has
        no payload column to copy), or ``None`` — nothing mutated — when
        the pool cannot supply the fresh blocks."""
        keys = self._with_headroom(keys, length)
        res = self.pool.import_blocks(keys)
        if res is None:
            return None
        ids, needs = res
        self.blocks[slot] = list(ids)
        self.keys[slot] = list(keys)
        self.tables[slot, :] = 0
        self.tables[slot, :len(ids)] = ids
        self.admit_seq[slot] = self._counter
        self._counter += 1
        return ids, needs

    # ------------------------------------------------------------- teardown
    def free_slot(self, slot: int) -> None:
        for b in self.blocks[slot]:
            if b:   # 0 marks a live-spilled (cold) position
                self.pool.decref(b)
        for hb in self.host_ids[slot]:
            # registered host blocks demote to the evictable cold cache;
            # unregistered duplicates free outright
            self.pool.host_decref(hb)
        self.blocks[slot] = []
        self.keys[slot] = []
        self.tables[slot, :] = 0
        self.admit_seq[slot] = -1
        self._chunk_keys.pop(slot, None)
        self.host_tables[slot, :] = 0
        self.host_ids[slot] = []
        self.cold_blocks[slot] = 0

    def youngest(self, slots) -> int:
        return max(slots, key=lambda s: self.admit_seq[s])
