"""Carry a parameter tree across from numpy into the port's tensors.

The tests build weights with the JAX package, convert them with
``jax.tree.map(np.asarray, params)`` and hand the numpy tree to
:func:`params_from_numpy`, so both frameworks compute the same function
key for key.  numpy has no native bfloat16; arrays of the ``ml_dtypes``
bfloat16 dtype that JAX hands out are widened to f32 (exact) and cast
back, which is exact too.  :func:`state_from_numpy` carries a whole train
state the same way, and :func:`shards_from_numpy` a placed model's weights:
each rank keeps only its shard of every (whole) array.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Pytree = Any


def _tensor(a: np.ndarray, device, dtype: torch.dtype | None) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Pytree, device: str | torch.device = "cpu",
                      dtype: torch.dtype | None = None) -> Pytree:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``; floating leaves are cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device, dtype)


def state_from_numpy(tree: Pytree, device: str | torch.device = "cpu") -> Pytree:
    """A whole train state carried across (``jax.tree.map(np.asarray,
    state)`` of the reference trainer's: ``params``, ``opt`` with ``m``,
    ``v`` and the int32 ``step``, and ``err`` under int8 compression) ->
    the port's state on ``device``, every leaf in its own dtype, so both
    packages can step from the same state."""
    missing = {"params", "opt"} - set(tree)
    if missing or {"m", "v", "step"} - set(tree["opt"]):
        raise KeyError(f"not a train state: keys {sorted(tree)}")
    return params_from_numpy(tree, device)


def shards_from_numpy(tree: Pytree, model, dtype: torch.dtype | None = None) -> Pytree:
    """Whole numpy weights -> this rank's shards for a placed ``model``
    (``build_model(..., env, mesh)``), on its device: each array is cut
    to the rank's part under ``model.param_specs()`` before it is copied,
    so a rank holds only its slice."""
    place, specs = model.placement, model.param_specs()

    def go(t, sp):
        if isinstance(t, dict):
            return {k: go(v, sp[k]) for k, v in t.items()}
        return _tensor(place.take(np.asarray(t), sp), model.device, dtype)

    return go(tree, specs)
