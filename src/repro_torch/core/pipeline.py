"""Sub-batch pipelining (paper Fig. 3) on CUDA streams.

Counterpart of ``repro.core.pipeline``.  The paper staggers sub-batches
so that the HPU computes attention for sub-batch *i* while the GPU runs
the linear layers of sub-batch *j*.  The reference splits the decode
batch into ``n_sub`` data-independent step computations and leaves their
overlap to XLA's latency-hiding scheduler.  The port makes the overlap
explicit: :func:`pipelined_step` launches each sub-batch's decode on its
own CUDA stream, forked from the caller's stream and joined back into it.
Inside a CUDA graph capture the fork and the join are captured too, so
the one graph of a dispatch kind holds ``n_sub`` parallel branches.  On
the CPU (or without streams) the sub-batches run one after another.

The step writes the cache in place: each sub-batch decodes against
*views* of the cache on the batch axis (:func:`split_cache` returns
views), so no sub-batch copies the cache and nothing is merged back.
:func:`tree_split`, :func:`tree_concat` and :func:`merge_cache` keep the
reference's functional forms for trees of tensors.

A placed model's cache (``core.offload.ShardedCache``: this rank's rows
only) splits into sub-batches that each take an equal part of every
lane's rows (``ShardedCache.split``), where the reference's ranges of
global rows would put a whole sub-batch on one lane under the batch
policy: each view is then cut as a cache of its size, the placed step
runs on it unchanged, and its rows' tokens and logits are gathered and
put back in the batch's order.  Every row's arithmetic is the same, so
tokens and stats are the reference's.  Placed steps hold gloo
collectives, which run eagerly, so the sub-batches run in order on the
rank's current stream.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch.core.offload import ShardedCache

Pytree = Any


def _split(t: torch.Tensor, n_sub: int, axis: int) -> tuple[torch.Tensor, ...]:
    """``n_sub`` equal views of ``t`` along ``axis`` (``jnp.split``'s rule:
    an unequal division raises)."""
    size = t.shape[axis]
    if size % n_sub:
        raise ValueError(f"array split does not result in an equal division: {size} rows "
                         f"into {n_sub} sub-batches")
    return torch.split(t, size // n_sub, dim=axis)


def tree_split(tree: Pytree, n_sub: int, axis: int = 0) -> list[Pytree]:
    """Split every leaf along ``axis`` into ``n_sub`` equal parts (views)."""

    def part(node, i):
        if isinstance(node, dict):
            return {k: part(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(part(v, i) for v in node)
        return _split(node, n_sub, axis)[i]

    return [part(tree, i) for i in range(n_sub)]


def tree_concat(trees: list[Pytree], axis: int = 0) -> Pytree:
    """Concatenate matching leaves of ``trees`` along ``axis``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_concat([t[k] for t in trees], axis) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_concat([t[i] for t in trees], axis)
                           for i in range(len(first)))
    return torch.cat(trees, dim=axis)


def default_batch_axes(cache: Pytree) -> dict[str, int]:
    """``lengths`` is (B,); stacked per-layer caches are (L, B, ...)."""
    return {k: (0 if k == "lengths" else 1) for k in cache}


def split_cache(cache: Pytree, n_sub: int, batch_axes: dict[str, int]) -> list[Pytree]:
    """Split a cache dict on each leaf's batch axis (leaf name -> axis,
    default 1) into ``n_sub`` caches of views: a write into a part is a
    write into ``cache``.  A placed cache splits by ``ShardedCache.split``."""
    if isinstance(cache, ShardedCache):
        return cache.split(n_sub)
    subs: list[dict] = [{} for _ in range(n_sub)]
    for k, v in cache.items():
        for i, part in enumerate(_split(v, n_sub, batch_axes.get(k, 1))):
            subs[i][k] = part
    return subs


def merge_cache(subs: list[Pytree], batch_axes: dict[str, int]) -> Pytree:
    """The reference's functional merge: each leaf's parts concatenated on
    its batch axis (a copy; :func:`pipelined_step` needs none, its parts
    are views).  Placed parts merge by ``ShardedCache.merge``."""
    if isinstance(subs[0], ShardedCache):
        return ShardedCache.merge(subs)
    return {k: torch.cat([s[k] for s in subs], dim=batch_axes.get(k, 1)) for k in subs[0]}


_STREAMS: dict[torch.device, list[torch.cuda.Stream]] = {}


def sub_batch_streams(device: torch.device, n_sub: int) -> list[torch.cuda.Stream]:
    """The first ``n_sub`` of the device's sub-batch streams, made at first
    use and shared by every engine on the device (engines step one at a
    time): a stream holds a cuBLAS workspace for the life of the process
    (``serving/programs.py``)."""
    device = torch.device(device)
    if device.index is None:                    # "cuda" and "cuda:0" are one card
        device = torch.device(device.type, torch.cuda.current_device())
    streams = _STREAMS.setdefault(device, [])
    while len(streams) < n_sub:
        streams.append(torch.cuda.Stream(device))
    return streams[:n_sub]


def pipelined_step(
    decode_fn: Callable[[Pytree, Pytree, torch.Tensor], tuple[torch.Tensor, Pytree]],
    n_sub: int,
    streams: Sequence[torch.cuda.Stream] | None = None,
) -> Callable[[Pytree, Pytree, torch.Tensor], tuple[torch.Tensor, Pytree]]:
    """Wrap a decode step so that it runs as ``n_sub`` sub-batches, each
    against views of the cache.  With ``streams`` (one per sub-batch) and
    CUDA tensors, sub-batch *i* is launched on ``streams[i]``, forked from
    the current stream and joined back into it before the logits are
    concatenated; otherwise the sub-batches run in order on the current
    stream.  Over a placed cache each sub-batch's tokens are its rows of
    ``tokens`` (``ShardedCache.sub_rows``) and the logits go back to the
    batch's row order."""
    if n_sub <= 1:
        return decode_fn
    if streams is not None and len(streams) != n_sub:
        raise ValueError(f"{len(streams)} streams for {n_sub} sub-batches")

    def step(params, cache, tokens):
        cache_subs = split_cache(cache, n_sub, default_batch_axes(cache))
        if isinstance(cache, ShardedCache):
            rows = [torch.tensor(cache.sub_rows(n_sub, i), device=tokens.device)
                    for i in range(n_sub)]
            logits = torch.cat([decode_fn(params, c, tokens[r])[0]
                                for c, r in zip(cache_subs, rows)], 0)
            return logits.index_copy(0, torch.cat(rows), logits), cache
        token_subs = _split(tokens, n_sub, 0)
        if streams is None or not tokens.is_cuda:
            outs = [decode_fn(params, c, t)[0] for c, t in zip(cache_subs, token_subs)]
            return torch.cat(outs, 0), cache
        main = torch.cuda.current_stream(tokens.device)
        outs = []
        for s, c, t in zip(streams, cache_subs, token_subs):
            s.wait_stream(main)                     # fork
            with torch.cuda.stream(s):
                outs.append(decode_fn(params, c, t)[0])
        for s in streams:
            main.wait_stream(s)                     # join
        return torch.cat(outs, 0), cache

    return step


__all__ = ["default_batch_axes", "merge_cache", "pipelined_step", "split_cache",
           "tree_concat", "tree_split"]
