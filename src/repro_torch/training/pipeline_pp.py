"""Pipeline parallelism (GPipe schedule) over a mesh axis.

Counterpart of ``repro.training.pipeline_pp``: the layer stack is split
into ``n_stages`` contiguous stages (:func:`split_stages`), each held by
one rank of the mesh's ``stage`` axis; microbatches stream through with a
GPipe schedule of ``n_micro + n_stages - 1`` ticks, and the bubble is the
usual ``(n_stages - 1) / (n_micro + n_stages - 1)``.

The reference runs the schedule inside ``shard_map`` and moves boundary
activations by ``lax.ppermute``, whose transpose gives ``jax.grad`` exact
gradients.  The port runs one process per stage and moves them by
``collectives.Shift`` (a send to the next stage and a receive from the one
before, cyclically; its backward sends the gradient the other way), so
``torch.autograd`` through :func:`pipeline_forward` gives exact gradients
too.  As in the reference every stage runs its block at every tick (the
inactive ticks on a stand-in whose output is masked to zeros) and sends
at every tick: the autograd graph is then the same on every rank, and the
backward's sends and receives pair up tick by tick.  The last stage's
outputs reach every rank through a masked sum over the axis
(``collectives.reduce_from``: its backward is the identity, so a loss
that every rank computes from the replicated output counts once).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.training.optimizer import tree_map

Pytree = Any


def split_stages(stacked_params: Pytree, n_stages: int) -> Pytree:
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""

    def reshape(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))

    return tree_map(reshape, stacked_params)


def pipeline_forward(block_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
                     stage_params: Pytree, x: torch.Tensor, mesh,
                     axis: str = "stage") -> torch.Tensor:
    """GPipe forward: ``(n_micro, micro_B, S, D)`` final activations, the
    same on every rank of ``axis``.

    ``block_fn(params_one_stage, h)`` applies one stage's layers.
    ``stage_params`` is this rank's shard of :func:`split_stages`' output
    along ``axis`` (leaves ``(1, L/n_stages, ...)``, the reference's
    ``params_local``); ``x`` is every microbatch, on every rank (only the
    first stage reads it)."""
    n_stages = mesh.size_of(axis)
    stage = mesh.index((axis,))
    group = mesh.group((axis,))
    n_micro = x.shape[0]
    params = tree_map(lambda a: a[0], stage_params)
    T = n_micro + n_stages - 1

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=x.device)

    first, last = flag(stage == 0), flag(stage == n_stages - 1)
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(T):
        mb = t - stage                     # the microbatch on this stage at tick t
        # the first stage ingests the microbatch, the others what they received
        inject = torch.where(first, x[min(max(mb, 0), n_micro - 1)], buf)
        h = torch.where(flag(0 <= mb < n_micro), block_fn(params, inject), 0.0)
        if t >= n_stages - 1:              # the last stage finishes microbatch t - (S - 1)
            outs.append(torch.where(last, h, 0.0))
        if t + 1 < T and group is not None:
            buf = collectives.Shift.apply(h, group, 1)
    return collectives.reduce_from(torch.stack(outs), group)


def sequential_reference(block_fn, stage_params, x: torch.Tensor, n_stages: int) -> torch.Tensor:
    """Same math without the pipeline (for tests): apply stages in order."""
    out = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(n_stages):
            h = block_fn(tree_map(lambda a: a[s], stage_params), h)
        out.append(h)
    return torch.stack(out)
