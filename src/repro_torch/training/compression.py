"""Gradient compression for the data-parallel all-reduce: int8 with error
feedback (the residual carried across steps).

Counterpart of ``repro.training.compression``, in the form its trainer
computes under ``jax.jit``, which is not the form its source reads as:

* the scale ``max(amax, 1e-12) / 127`` compiles to ``max(amax, 1e-12) *
  f32(1 / 127)`` (XLA turns a division by a constant into a product with
  its reciprocal; the eager division differs in the last bit of ~5% of the
  scales);
* the new error ``g32 - q * scale`` compiles to one fused multiply-add,
  one rounding (``torch.addcmul``; two roundings differ in the last bit).

``torch.round`` rounds half to even like ``jnp.round``.  The payload is
decompressed at once (``compress_grads``), as in the reference's train
step; ``distributed.collectives.int8_psum`` is the compressed all-reduce
whose wire bytes it stands for.  On a mesh each rank compresses its
shard of a gradient (the trainer's ZeRO shard, with the error tree held
as a shard too) and the scale's amax is the whole leaf's: reduced (MAX)
over the leaf's split axes, as GSPMD reduces it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import collectives
from repro_torch.training.optimizer import tree_map

Pytree = Any

INT8_MAX = 127.0


def init_error(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _one(g: torch.Tensor, e: torch.Tensor, group=None):
    g32 = g.float() + e
    amax = collectives.all_reduce_max(g32.abs().max(), group)
    scale = torch.clamp(amax, min=1e-12) * (1.0 / INT8_MAX)
    q = torch.clamp(torch.round(g32 / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale, torch.addcmul(g32, q.float(), scale, value=-1.0)


def compress(grads: Pytree, error: Pytree):
    """-> (int8 payload, f32 scales, new error), trees like ``grads``."""
    out = tree_map(_one, grads, error)
    return tuple(_pick(out, i) for i in range(3))


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def decompress(q: Pytree, scales: Pytree) -> Pytree:
    return tree_map(lambda qi, si: qi.float() * si, q, scales)


def compress_grads(grads: Pytree, error: Pytree, groups: Pytree = None):
    """Round trip (the numerics of a compressed all-reduce) + new error:
    ``(decompress(*compress(...)[:2]), new error)``, one leaf at a time.
    The new error is written **in place** into ``error`` (returned), so a
    full-width state holds one error tree, not two.  On a mesh ``groups``
    (a tree like ``grads``) gives each shard's group of split axes."""

    def one(g, e, group=None):
        q, scale, new_e = _one(g, e, group)
        e.copy_(new_e)
        return q.float() * scale

    with torch.no_grad():
        if groups is None:
            return tree_map(one, grads, error), error
        return tree_map(one, grads, error, groups), error
