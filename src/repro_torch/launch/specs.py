"""Input stand-ins and cache specs for an (arch x shape) cell.

Counterpart of ``repro.launch.specs`` (``prefill_inputs``,
``decode_inputs``, ``cache_shardings``): tensors on the ``meta`` device
(shape and dtype, no storage) and the resolved
:class:`~repro_torch.models.common.Spec` of every cache leaf under the
model's KV policy, which the tests and the later dry run read.  Modality
frontends are stubs: internvl2 gets (B, F, D) patch embeddings, seamless
(B, F, D) frame embeddings.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ENCDEC, ShapeConfig
from repro_torch.models.registry import Model, build_model

Pytree = Any


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def cache_shapes(model: Model, batch: int, max_seq: int) -> Pytree:
    """The whole cache of ``batch`` x ``max_seq`` as meta tensors, in the
    dtypes ``init_cache`` gives its leaves (one device's, not a shard)."""
    return build_model(model.cfg, "meta").init_cache(batch, max_seq)


def prefill_inputs(model: Model, shape: ShapeConfig):
    """``(tokens, cache, embeds or None)`` stand-ins of a prefill."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    n_front = cfg.frontend_len if cfg.frontend == "patches" else 0
    tokens = sds((B, S - n_front if n_front else S), torch.int32)
    embeds = None
    if cfg.frontend == "patches" or cfg.family == ENCDEC:
        embeds = sds((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    return tokens, cache_shapes(model, B, S), embeds


def decode_inputs(model: Model, shape: ShapeConfig):
    """``(cache, tokens)`` stand-ins of one decode step over a full cache."""
    B, S = shape.global_batch, shape.seq_len
    return cache_shapes(model, B, S), sds((B,), torch.int32)


def cache_shardings(model: Model, shapes: Pytree) -> Pytree:
    """The Spec of every leaf of the cache ``shapes`` (from
    :func:`cache_shapes`) under the model's KV policy, resolved at the
    leaves' real sizes."""
    return model.cache_specs(*_cache_dims(shapes))


def _cache_dims(shapes: Pytree) -> tuple[int, int]:
    """``(batch, max_seq)`` of a cache's stand-ins."""
    seq = 0
    for k, v in shapes.items():
        if k in ("k", "v", "ckv", "krope") and v.dim() >= 3:
            seq = max(seq, v.shape[2])
    return shapes["lengths"].shape[0], seq
