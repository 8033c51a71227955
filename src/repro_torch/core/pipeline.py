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
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch

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
    write into ``cache``."""
    subs: list[dict] = [{} for _ in range(n_sub)]
    for k, v in cache.items():
        for i, part in enumerate(_split(v, n_sub, batch_axes.get(k, 1))):
            subs[i][k] = part
    return subs


def merge_cache(subs: list[Pytree], batch_axes: dict[str, int]) -> Pytree:
    """The reference's functional merge: each leaf's parts concatenated on
    its batch axis (a copy; :func:`pipelined_step` needs none, its parts
    are views)."""
    return {k: torch.cat([s[k] for s in subs], dim=batch_axes.get(k, 1)) for k in subs[0]}


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
    stream."""
    if n_sub <= 1:
        return decode_fn
    if streams is not None and len(streams) != n_sub:
        raise ValueError(f"{len(streams)} streams for {n_sub} sub-batches")

    def step(params, cache, tokens):
        axes = default_batch_axes(cache)
        cache_subs = split_cache(cache, n_sub, axes)
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
