"""Decode and prefill attention routed to the device that holds the data.

Counterpart of ``repro.core.offload`` (``decode_attention``,
``paged_decode_attention``, ``prefill_attention`` and
``mla_decode_attention``).  On one device the choice is only of the
implementation: the Hopper kernels for CUDA tensors, the model-level
plain versions (``models/attention.py``, the reference engine's
numerics) for CPU tensors.

On a mesh the reference splits the compute side and the KV cache
differently (the paper's GPU/HPU split as a layout split): activations
over ``pod``/``data`` by rows and ``model`` by heads, the cache as its
policy says (``core.placement``), and GSPMD reshards the per-token q and
the output at the boundary.  The port runs one process per rank and
writes the boundary out (:class:`Placement`, :func:`placed_decode_attention`):
a tensor moves between two layouts by gathering each dim this rank does
not hold enough of over the axes it is split on, then slicing; the
sequence policies run the kernel with its log-sum-exp over each rank's
window and merge the gathered partials.  :class:`ShardedCache` is a
cache of this rank's shards with the global extents they cut.

The paged pool (:class:`ShardedPool`) is cut by its ``kv_blocks`` rule:
the physical block axis replaces the batch axis as the unit the HPU lanes
split, and a block belongs to exactly one lane.  A row's blocks may lie
on any lane, so every lane of a block or position cut takes every row's
query (the per-token Q/K/V descriptors are the boundary traffic), runs
the paged kernel over its part of each row through a table of its own
(:func:`lane_tables`, built on the device), and the lanes' partials are
merged by log-sum-exp (:func:`placed_paged_decode_attention`).  The host
tier's block axis is never split: each rank attends the cold window on
its share of every host block, and the hot and cold windows' partials of
every rank merge in one log-sum-exp merge (:func:`_merge_windows`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.placement import Env
from repro_torch.distributed import collectives
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

Range = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Placement:
    """One rank of ``mesh`` under ``env``: its part of every layout, and the
    collectives between layouts.  ``specs`` is the model's resolved
    parameter specs (the family reads its tensor-parallel axes there)."""
    env: Env
    mesh: object                     # launch.mesh.DeviceMesh
    specs: dict

    def part(self, axes: tuple[str, ...], n: int) -> Range:
        """This rank's range of a dim of ``n`` split over ``axes``."""
        k = self.mesh.size(axes)
        i = self.mesh.index(axes)
        return i * n // k, (i + 1) * n // k

    def local_shape(self, spec, shape) -> tuple[int, ...]:
        """The shape of this rank's shard of a whole ``shape`` under ``spec``."""
        return tuple(hi - lo for lo, hi in (self.part(spec.axes(d), n)
                                            for d, n in enumerate(shape)))

    def take(self, x, spec):
        """This rank's shard of a whole ``x`` (a tensor or an array) split
        per dim as ``spec`` (a ``models.common.Spec``) says: views."""
        for d in range(len(spec)):
            lo, hi = self.part(spec.axes(d), x.shape[d])
            x = x[(slice(None),) * d + (slice(lo, hi),)]
        return x

    def reduce(self, x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        return collectives.all_reduce(x, self.mesh.group(axes))

    def gather(self, x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
        return collectives.all_gather(x, self.mesh.group(axes), dim)

    def stack_all(self, xs: list[torch.Tensor], axes: tuple[str, ...]) -> list[torch.Tensor]:
        """Every rank's ``xs`` stacked over ``axes``, each ``(n, *x.shape)``,
        in one collective: flattened into one buffer of their common dtype
        (a widening, exact both ways) and split again."""
        group = self.mesh.group(axes)
        if group is None:
            return [x[None] for x in xs]
        dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
        flat = torch.cat([x.reshape(-1).to(dt) for x in xs])
        stack = collectives.gather_stack(flat, group)
        out, off = [], 0
        for x in xs:
            out.append(stack[:, off:off + x.numel()].reshape(-1, *x.shape).to(x.dtype))
            off += x.numel()
        return out

    def reshard(self, x: torch.Tensor, src: list[tuple[str, ...]],
                dst: list[tuple[tuple[str, ...], Range]], full: list[int]) -> torch.Tensor:
        return self.reshard_all([x], src, [dst], [full])[0]

    def reshard_all(self, xs: list[torch.Tensor], src: list[tuple[str, ...]],
                    dsts: list[list[tuple[tuple[str, ...], Range]]],
                    fulls: list[list[int]]) -> list[torch.Tensor]:
        """Each ``x``, this rank's part of a tensor of shape ``full`` split
        per dim over the axes ``src`` (the same for every x), moved to its
        ``dst``: per dim the axes it is split over there (the same for
        every x) and this rank's range (the part of those axes, or a range
        inside it).  A dim is gathered over its ``src`` axes unless they
        lead its ``dst`` axes (the new part then lies inside the one held):
        a choice every rank of the group makes alike; the tensors are
        gathered together, one collective a dim.  All gathers come before
        any cut, since a cut dim would differ across the next gather's
        group."""
        have = [[self.part(a, n) for a, n in zip(src, full)] for full in fulls]
        for d, (axes, _) in enumerate(dsts[0]):
            if not self._leads(src[d], axes):
                stacks = self.stack_all(xs, src[d])
                xs = [torch.cat(st.unbind(0), dim=d) for st in stacks]
                for h, full in zip(have, fulls):
                    h[d] = (0, full[d])
        out = []
        for x, h, dst in zip(xs, have, dsts):
            for d, (_, (lo, hi)) in enumerate(dst):
                if (lo, hi) != h[d]:
                    x = x.narrow(d, lo - h[d][0], hi - lo)
            out.append(x)
        return out

    def _leads(self, a: tuple[str, ...], b: tuple[str, ...]) -> bool:
        """Whether the live axes of ``a`` are a prefix of ``b``'s."""
        a, b = self.mesh._live(a), self.mesh._live(b)
        return b[:len(a)] == a

    def split(self, axes: tuple[str, ...]) -> bool:
        """Whether ``axes`` split a dim over more than one rank."""
        return self.mesh.size(axes) > 1

    def stack_mesh(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """:meth:`stack_all` over every axis of the mesh: each ``x`` of
        every rank, ``(n_ranks, *x.shape)``, in one collective."""
        mesh = self.mesh
        return self.stack_all(xs, tuple(a for a in mesh.axis_names if mesh.size_of(a) > 1))


class ShardedCache(dict):
    """This rank's shards of a dense cache (``k``/``v`` ``(L, b, s, h,
    Dh)``, ``lengths`` ``(b,)``) of a global ``(batch, max_seq, n_kv)``:
    rows ``rows`` split over ``row_axes``, positions ``seq`` over
    ``seq_axes``, KV heads ``heads`` over ``head_axes``.  A slot's view
    (:meth:`slot_view`) is a cache of one row, held by the rank that owns
    it and empty elsewhere.  ``place`` is the rank's :class:`Placement`
    (a slot gathered whole for migration runs its collective)."""

    def __init__(self, leaves: dict, *, batch: int, max_seq: int, n_kv: int, rows: Range,
                 seq: Range, heads: Range, row_axes=(), seq_axes=(), head_axes=(),
                 place: Placement | None = None):
        super().__init__(leaves)
        self.batch, self.max_seq, self.n_kv = batch, max_seq, n_kv
        self.rows, self.seq, self.heads = rows, seq, heads
        self.row_axes, self.seq_axes, self.head_axes = row_axes, seq_axes, head_axes
        self.place = place

    def local_row(self, row: int) -> int | None:
        """The local index of global row ``row``, None when not held here."""
        lo, hi = self.rows
        return row - lo if lo <= row < hi else None

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole ``(batch, ...)`` tensor (a view)."""
        return x[self.rows[0]:self.rows[1]]

    def _view(self, leaves: dict, batch: int, rows: Range) -> "ShardedCache":
        return ShardedCache(leaves, batch=batch, max_seq=self.max_seq, n_kv=self.n_kv,
                            rows=rows, seq=self.seq, heads=self.heads, row_axes=self.row_axes,
                            seq_axes=self.seq_axes, head_axes=self.head_axes, place=self.place)

    def split(self, n_sub: int) -> list["ShardedCache"]:
        """``n_sub`` sub-batch caches of views, each of ``batch // n_sub``
        rows: sub-batch ``i`` holds the ``i``-th of ``n_sub`` equal parts of
        every lane's rows (:meth:`sub_rows`), so that it spans every lane as
        the whole batch does and each view is cut as a cache of its size
        would be (a write into a view is a write into this cache).  Where the
        rows are not split this is the reference's split into ranges of
        global rows."""
        b = self.rows[1] - self.rows[0]
        if self.batch % n_sub or b % n_sub:
            raise ValueError(f"array split does not result in an equal division: {b} rows of "
                             f"{self.batch} on this rank into {n_sub} sub-batches")
        s, lane = b // n_sub, self.rows[0] // b
        return [self._view({k: v.narrow(0 if k == "lengths" else 1, i * s, s)
                            for k, v in self.items()},
                           self.batch // n_sub, (lane * s, (lane + 1) * s))
                for i in range(n_sub)]

    def sub_rows(self, n_sub: int, i: int) -> list[int]:
        """The global rows of :meth:`split`'s sub-batch ``i``, in its order:
        the ``i``-th part of each lane's rows, lane after lane."""
        b = self.rows[1] - self.rows[0]
        s = b // n_sub
        return [j * b + i * s + t for j in range(self.batch // b) for t in range(s)]

    @staticmethod
    def merge(subs: list["ShardedCache"]) -> "ShardedCache":
        """The inverse of :meth:`split`: each leaf's local parts concatenated
        (a copy)."""
        first = subs[0]
        b = (first.rows[1] - first.rows[0]) * len(subs)
        lane = first.rows[0] // max(first.rows[1] - first.rows[0], 1)
        leaves = {k: torch.cat([c[k] for c in subs], dim=0 if k == "lengths" else 1)
                  for k in first}
        return first._view(leaves, first.batch * len(subs), (lane * b, (lane + 1) * b))

    def put_length(self, slot: torch.Tensor, value: torch.Tensor) -> None:
        """``lengths[slot] = value`` for a ``(1,)`` device ``slot`` (a
        global row), on the rank that holds it, with no host sync."""
        lengths = self["lengths"]
        r0, r1 = self.rows
        if r1 == r0:
            return
        row = slot.long().reshape(1) - r0
        held = (row >= 0) & (row < r1 - r0)
        row = row.clamp(0, r1 - r0 - 1)
        lengths.index_put_((row,), torch.where(held, value.to(lengths.dtype), lengths[row]))

    def slot_view(self, slot: int) -> "ShardedCache":
        """Global row ``slot`` as a cache of one row, of views: writing into
        it (a prefill) writes into this cache."""
        i = self.local_row(slot)
        n = 0 if i is None else 1
        i = 0 if i is None else i
        return ShardedCache({k: v.narrow(0 if k == "lengths" else 1, i, n)
                             for k, v in self.items()},
                            batch=1, max_seq=self.max_seq, n_kv=self.n_kv, rows=(0, n),
                            seq=self.seq, heads=self.heads, seq_axes=self.seq_axes,
                            head_axes=self.head_axes, place=self.place)


def placed_decode_attention(place: Placement, cache: ShardedCache, layer: int,
                            q: torch.Tensor, act: list[tuple[str, ...]],
                            lengths: torch.Tensor, kv=None) -> torch.Tensor:
    """One decode step of attention in the cache's layout.

    ``q`` is the query in the cache's layout (its rows, the query heads of
    its KV heads: ``cache_layout``), ``lengths`` (its rows) counts the new
    token; returns the output in the compute layout (rows over ``act[0]``,
    heads over ``act[1]``).  The kernel runs on the local shard.  With the
    positions split (the sequence and batch_seq policies) each rank
    attends over its window ``[s0, s1)`` with the lengths clamped to it,
    and the gathered ``(out, lse)`` partials are merged by log-sum-exp
    (``ref.lse_merge``); a window a row has not reached is empty and
    weighs 0.  On CUDA the window runs the decode kernel with its lse
    output; on the CPU the plain version, whose windows first share their
    maximum (one more all-reduce) so that it keeps the reference's
    rounding of p.  ``kv``, when given, is the layer's ``(K, V)`` shard to
    read in place of the cache's (the ``kv_quant`` cache dequantized)."""
    B, D = cache.batch, q.shape[2]
    Hq = q.shape[1] * cache.n_kv // (cache.heads[1] - cache.heads[0])
    k_l, v_l = kv if kv is not None else (cache["k"][layer], cache["v"][layer])
    if not place.split(cache.seq_axes):
        o = decode_attention(q, k_l, v_l, lengths)
    else:
        s0, s1 = cache.seq
        window = (lengths - s0).clamp(0, s1 - s0)
        if q.is_cuda:
            o, lse = ops.decode_attention(q, k_l, v_l.to(k_l.dtype), window, return_lse=True)
        else:
            # the windows share their maximum, so that p rounds as in the
            # reference's one softmax over the whole cache
            m = attn.decode_scores(q, k_l, window).amax(dim=-1, keepdim=True)
            m = collectives.all_reduce_max(m, place.mesh.group(cache.seq_axes))
            o, lse = attn.decode_attention(q, k_l, v_l, window, m=m, return_lse=True)
        os, lses = place.stack_all([o, lse], cache.seq_axes)
        o = ref.lse_merge(list(zip(os.unbind(0), lses.unbind(0))))
    dst = [(act[0], place.part(act[0], B)), (act[1], place.part(act[1], Hq)), ((), (0, D))]
    return place.reshard(o, [cache.row_axes, cache.head_axes, ()], dst, [B, Hq, D])


class ShardedPool(dict):
    """This rank's shards of a paged pool (``k``/``v`` ``(L, n, h, p, Dh)``
    and an fp8/int8 pool's ``k_scale``/``v_scale`` ``(L, n, h, p)``) of a
    global ``(n_blocks, n_kv, block_size)``, as the ``kv_blocks`` placement
    cuts it: physical blocks ``blocks`` split over ``block_axes``, KV heads
    ``heads`` over ``head_axes``, the positions inside every block ``pos``
    over ``pos_axes``.  ``block_tables`` and ``lengths`` are whole on every
    rank: a row's blocks may lie on any lane, so every lane reads every
    row's table (a few KB).  ``nbytes`` is the whole pool's size, what one
    device would hold (the host tier's leaves included, as the reference's
    ``kv_bytes`` counts them).

    The host tier (``host_k``/``host_v`` ``(L, n_host, h, p, Dh)``, their
    scale pools, ``host_tables`` and ``cold_lengths`` whole) takes the
    reference's logical axes ``("layers", None, "kv_heads", "kv_seq",
    "head_dim")``: its block axis is never split, so every rank holds every
    host block, cut by KV heads ``host_heads`` over ``host_head_axes`` (the
    device pool's heads: the same rule on the same count) and by the
    positions in a block ``host_pos`` over ``host_pos_axes``."""

    def __init__(self, leaves: dict, *, place: Placement, n_blocks: int, n_kv: int,
                 block_size: int, blocks: Range, heads: Range, pos: Range, block_axes=(),
                 head_axes=(), pos_axes=(), nbytes: int = 0, host_pos: Range | None = None,
                 host_pos_axes=()):
        super().__init__(leaves)
        self.place = place
        self.n_blocks, self.n_kv, self.block_size = n_blocks, n_kv, block_size
        self.blocks, self.heads, self.pos = blocks, heads, pos
        self.block_axes, self.head_axes, self.pos_axes = block_axes, head_axes, pos_axes
        self.nbytes = nbytes
        self.host_pos = (0, block_size) if host_pos is None else host_pos
        self.host_pos_axes = host_pos_axes

    @property
    def merge_axes(self) -> tuple[str, ...]:
        """The axes whose lanes hold disjoint parts of a row's positions
        (the block and the position cuts), in mesh order: the partials of
        a row are merged over them."""
        cut = set(self.block_axes) | set(self.pos_axes)
        return tuple(a for a in self.place.mesh.axis_names if a in cut)

    def local_block(self, phys: int) -> int | None:
        """The local index of physical block ``phys``, None when another
        lane holds it."""
        b0, b1 = self.blocks
        return phys - b0 if b0 <= phys < b1 else None

    def owner(self, phys: int) -> int:
        """The index, over ``block_axes``, of the lane holding ``phys``
        (the split divides the block count)."""
        return phys // (self.blocks[1] - self.blocks[0])

    @property
    def host_merge_axes(self) -> tuple[str, ...]:
        """The axes whose ranks hold disjoint positions of the host tier's
        blocks: the cold window's partials are merged over them."""
        return self.place.mesh._live(self.host_pos_axes)

    @property
    def n_host(self) -> int:
        """Host-tier blocks, its null block 0 included (0 without a tier)."""
        return self["host_k"].shape[1] if "host_k" in self else 0

    def lane_tables(self, tables: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`lane_tables` of this lane over the device pool; ``starts``
        (the cold lengths) opens each row's hot window there."""
        return lane_tables(tables, lengths, self.block_size, self.n_blocks, self.blocks,
                           self.pos, starts)

    def host_lane_tables(self, tables: torch.Tensor, lengths: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`lane_tables` of this rank's share of the host tier (every
        block, its positions ``host_pos``): the cold window ``[0,
        lengths)``."""
        return lane_tables(tables, lengths, self.block_size, self.n_host, (0, self.n_host),
                           self.host_pos)


def lane_tables(tables: torch.Tensor, lengths: torch.Tensor, block_size: int, n_blocks: int,
                blocks: Range, pos: Range, starts: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A lane's view of every row, on the device with no host sync: ``(tables
    (B, MB) int32 of local block ids, lengths (B,))`` for the paged kernel
    over the shard of physical blocks ``blocks`` and positions ``pos`` of
    every block.  ``lengths`` counts the positions a row attends (the
    kernel reads ``min(lengths, MB * block_size)``).  Block cut: a row's
    live blocks held here, in logical order (a stable sort puts them
    first), so the partial last block, if held, stays last; position cut
    ``[p0, p1)``: every block contributes ``p1 - p0`` positions, the last
    one those of its tail past ``p0``.  ``starts`` (whole blocks: the host
    tier's cold prefix, whose table columns name the null block) drops
    each row's blocks below it the same way, so the window is ``[starts,
    lengths)`` with no ``starts`` for the kernel.  A lane that holds nothing
    of a row gives it length 0: an empty window, which weighs 0 in the
    merge."""
    bs, MB = block_size, tables.shape[1]
    (b0, b1), (p0, p1) = blocks, pos
    bl = p1 - p0
    n_live = ((lengths.long() + bs - 1) // bs).clamp(max=MB)                  # (B,)
    tail = (lengths.long() - (n_live - 1) * bs).clamp(0, bs)                  # last block's
    col = torch.arange(MB, device=tables.device)[None]
    held = col < n_live[:, None]
    if starts is not None:
        held = held & (col >= (starts.long() // bs)[:, None])
    if (b0, b1) != (0, n_blocks) or starts is not None:
        held = held & (tables >= b0) & (tables < b1)
        order = torch.argsort((~held).to(torch.int8), dim=1, stable=True)
        tables = (tables.gather(1, order) - b0).clamp(0, b1 - b0 - 1).to(torch.int32)
    last = held.gather(1, (n_live - 1).clamp(min=0)[:, None])[:, 0] & (n_live > 0)
    local = (held.sum(dim=1) - last.long()) * bl + torch.where(last, (tail - p0).clamp(0, bl), 0)
    return tables.contiguous(), local.to(torch.int32)


def placed_paged_decode_attention(pool: ShardedPool, layer: int, q: torch.Tensor,
                                  act: list[tuple[str, ...]], tables: torch.Tensor,
                                  lengths: torch.Tensor, cold=None) -> torch.Tensor:
    """One decode step of attention over the paged pool in its placement.

    ``q`` holds every row (a row's blocks may lie on any lane) and the
    query heads of this rank's KV heads (:func:`pool_layout`);
    ``tables``/``lengths`` are :meth:`ShardedPool.lane_tables`' (the
    length counts the new token); returns the output in the compute
    layout (rows over ``act[0]``, heads over ``act[1]``).  A pool cut only
    by heads runs the one-device path on the shard.  A pool cut by blocks
    or by positions runs the paged kernel with its log-sum-exp over this
    lane's part of every row, and the partials gathered over the cut axes
    are merged by log-sum-exp (``ref.lse_merge``); on the CPU the plain
    version, whose lanes first share each row's score maximum (one more
    all-reduce) so that p rounds as in the reference's one softmax.

    With the host tier, ``cold`` is :meth:`ShardedPool.host_lane_tables`'
    ``(tables, lengths)`` and ``tables``/``lengths`` the hot window's (from
    the cold length on): each rank attends the hot window on its lane of
    the device pool and the cold window on its share of the host tier,
    each with its lse (on the CPU the reference's kernel-level oracle, each
    window's maximum shared over the ranks that split it), and every
    partial merges in one lse merge (:func:`_merge_windows`), as one rank
    merges its hot and cold windows.  A window that the merge's axes do
    not all split (the cold one under the batch policy: every rank holds
    the whole host tier) is attended on each rank for its part of the
    rows over the other axes only, the rest given length 0, so that each
    row's window is computed once across the mesh."""
    place = pool.place
    B, D = q.shape[0], q.shape[2]
    Hq = q.shape[1] * pool.n_kv // (pool.heads[1] - pool.heads[0])
    merge = pool.merge_axes
    hot = _pool_layer(pool, "", layer)
    if cold is None and not place.split(merge):
        o = paged_decode_attention(q, *hot[:2], tables, lengths, k_scale=hot[2],
                                   v_scale=hot[3])
    else:
        oracle = cold is not None
        windows = [(merge, hot, tables, lengths)]
        if cold is not None:
            windows.append((pool.host_merge_axes, _pool_layer(pool, "host_", layer), *cold))
        cut = set().union(*(set(w[0]) for w in windows))
        union = tuple(a for a in place.mesh.axis_names if a in cut)
        parts = []
        for axes, kv, tbl, lens in windows:
            rest = tuple(a for a in union if a not in axes)
            if place.split(rest):
                r0, r1 = place.part(rest, B)
                rows = torch.arange(B, device=lens.device)
                lens = torch.where((rows >= r0) & (rows < r1), lens, 0).to(lens.dtype)
            parts.append(_window(place, axes, q, kv, tbl, lens, oracle))
        o = _merge_windows(place, parts, union)
    dst = [(act[0], place.part(act[0], B)), (act[1], place.part(act[1], Hq)), ((), (0, D))]
    return place.reshard(o, [(), pool.head_axes, ()], dst, [B, Hq, D])


def _pool_layer(pool: ShardedPool, prefix: str, layer: int) -> tuple:
    """``(k, v, k_scale, v_scale)`` of ``layer`` in the device pool
    (``prefix`` "") or the host tier ("host_"); the scales None for a
    bf16/f32 pool."""
    ks = pool.get(f"{prefix}k_scale")
    vs = pool.get(f"{prefix}v_scale")
    return (pool[f"{prefix}k"][layer], pool[f"{prefix}v"][layer],
            None if ks is None else ks[layer], None if vs is None else vs[layer])


def _window(place: Placement, axes: tuple[str, ...], q: torch.Tensor, kv: tuple,
            tables: torch.Tensor, lengths: torch.Tensor, oracle: bool):
    """This rank's ``(out, lse)`` of one window of every row: the paged
    kernel on CUDA; on the CPU the plain version, its maximum shared over
    ``axes`` where they split the window (``oracle``: the kernel-level
    oracle's numerics, as one rank's tiered attention has them)."""
    k_l, v_l, ks_l, vs_l = kv
    if q.is_cuda:
        return ops.paged_decode_attention(q, k_l, v_l, tables, lengths, k_scale=ks_l,
                                          v_scale=vs_l, return_lse=True)
    group = place.mesh.group(axes) if place.split(axes) else None
    return _lane_attention_plain(group, q, k_l, v_l, ks_l, vs_l, tables, lengths, oracle)


def _merge_windows(place: Placement, parts: list, axes: tuple[str, ...]) -> torch.Tensor:
    """One lse merge of every rank's window partials ``(out, lse)``,
    gathered over ``axes`` in one collective: each row's part of each
    window is computed on one rank of them (the others give it length 0,
    an empty window whose weight is 0)."""
    stacks = place.stack_all([x for part in parts for x in part], axes)
    return ref.lse_merge([(o, lse) for os, lses in zip(stacks[::2], stacks[1::2])
                          for o, lse in zip(os.unbind(0), lses.unbind(0))])


def _lane_attention_plain(group, q, k_l, v_l, ks_l, vs_l, tables, lengths, oracle=False):
    """A lane's ``(out, lse)`` on the CPU, the windows sharing each row's
    maximum over ``group`` (None: a window no rank splits): the one-device
    path's numerics (the model-level decode attention for a bf16/f32 pool,
    the kernel-level oracle for an fp8/int8 one or with ``oracle``) over
    the lane's blocks gathered in table order."""
    k = ref.gather_paged_cache(k_l, tables)
    v = ref.gather_paged_cache(v_l, tables)
    if ks_l is None and not oracle:
        m = attn.decode_scores(q, k, lengths).amax(dim=-1, keepdim=True)
        m = collectives.all_reduce_max(m, group)
        return attn.decode_attention(q, k, v, lengths, m=m, return_lse=True)
    k, v = k.float(), v.float()
    if ks_l is not None:
        k = k * ref.gather_paged_scales(ks_l, tables)[..., None]
        v = v * ref.gather_paged_scales(vs_l, tables)[..., None]
    shared = None if group is None else (lambda m: collectives.all_reduce_max(m, group))
    return ref.naive_decode_attention(q, k, v, lengths, return_lse=True, shared_max=shared)


def pool_layout(pool: ShardedPool, n_heads: int, width: int, batch: int) -> list:
    """The ``dst`` of :meth:`Placement.reshard_all` for a ``(batch,
    n_heads, width)`` tensor into the pool's layout: every row, the heads
    of this rank's KV heads."""
    g = n_heads // pool.n_kv
    return [((), (0, batch)), (pool.head_axes, (pool.heads[0] * g, pool.heads[1] * g)),
            ((), (0, width))]


def cache_layout(cache: ShardedCache, n_heads: int, width: int) -> list:
    """The ``dst`` of :meth:`Placement.reshard_all` for a ``(B, n_heads,
    width)`` tensor into the cache's layout (a query's heads follow the KV
    heads of their group)."""
    g = n_heads // cache.n_kv
    return [(cache.row_axes, cache.rows), (cache.head_axes,
                                           (cache.heads[0] * g, cache.heads[1] * g)),
            ((), (0, width))]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None,
                     return_lse: bool = False):
    """q (B, Hq, D); caches (B, S, Hkv, D); lengths (B,) -> (B, Hq, D)
    [, lse (B, Hkv, G) f32].  The kernel reads K and V in one dtype: a bf16
    V beside an f32 K (the dequantized ``kv_quant`` cache in float32 mode)
    is widened, exactly.  ``return_lse`` (a window of a cache split by
    positions) takes the kernel's lse output on CUDA and its plain version
    on the CPU."""
    if q.is_cuda:
        return ops.decode_attention(q, k_cache, v_cache.to(k_cache.dtype), lengths,
                                    scale=scale, return_lse=return_lse)
    if return_lse:
        return ref.naive_decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                          return_lse=True)
    return attn.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float | None = None, starts: torch.Tensor | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None, return_lse: bool = False):
    """q (B, Hq, D); pools (N, Hkv, bs, D) kernel-native; block_tables
    (B, MB) int32; lengths (B,) -> (B, Hq, D) [, lse (B, Hkv, G)].

    ``starts`` restricts attention to the hot window ``[start, length)``;
    ``k_scale``/``v_scale`` (N, Hkv, bs) f32 mark an fp8/int8 pool;
    ``return_lse`` also returns the log-sum-exp for an lse merge with
    another window's partial.  CPU tensors take the reference engine's
    branch: gather the blocks into a contiguous cache and run the
    model-level decode attention (same numerics as the dense cache); with
    ``starts``, scales or ``return_lse``, the kernel-level oracle."""
    if q.is_cuda:
        return ops.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                          scale=scale, starts=starts,
                                          return_lse=return_lse, k_scale=k_scale,
                                          v_scale=v_scale)
    if starts is None and k_scale is None and not return_lse:
        k = ref.gather_paged_cache(k_pool, block_tables)
        v = ref.gather_paged_cache(v_pool, block_tables)
        return attn.decode_attention(q, k, v, lengths, scale=scale)
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                      scale=scale, starts=starts, return_lse=return_lse,
                                      k_scale=k_scale, v_scale=v_scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int | torch.Tensor = 0, chunk: int = 1024) -> torch.Tensor:
    """Causal prefill (and train) attention; ``q_offset`` places q[:, 0] at
    an absolute position: a host int, or a ``(1,)`` int32 tensor on q's
    device (read by the kernel, or by the plain path, with no host sync).
    CUDA inputs that need a gradient (the train step) go through
    ``ops.FlashAttentionFn``: the flash kernel with its log-sum-exp and
    the flash backward kernel; serving keeps the plain kernel call.  CPU
    inputs take the plain ``chunked_attention``, under autograd when
    training."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            if isinstance(q_offset, torch.Tensor) or q_offset != 0:
                raise ValueError("prefill_attention: the train path takes q_offset 0")
            return ops.FlashAttentionFn.apply(q, k, v, None)
        return ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return attn.chunked_attention(q, k, v, causal=True, q_offset=q_offset, chunk=chunk)


def mla_decode_attention(q_latent: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """MLA absorbed decode over the latent cache (no head axis):
    q_latent (B, H, Dc), q_rope (B, H, Dr), ckv_cache (B, S, Dc),
    krope_cache (B, S, Dr), lengths (B,) -> (B, H, Dc).  The reference
    has no Pallas kernel here, so both devices run the plain version, with
    the reference's one-device f32 combine (``Env.bf16_combine`` off)."""
    return attn.mla_decode_attention(q_latent, q_rope, ckv_cache, krope_cache, lengths,
                                     scale=scale)
