"""The train step, made by ``make_train_step``.

Counterpart of ``repro.training.trainer``.  ``make_train_step(model,
run_cfg)`` returns:
  * ``init_state(seed)`` — the TrainState tree: ``params``, ``opt`` (AdamW
    ``m``, ``v`` and an int32 ``step``) and, under int8 gradient
    compression, ``err`` (the f32 error-feedback residual);
  * ``train_step(state, batch) -> (state, metrics)``; ``batch`` holds numpy
    arrays or tensors (``inputs``, ``targets``, ``mask``), moved to the
    model's device here;
  * ``state_shapes()`` — the same tree as tensors on the ``meta`` device
    (shapes and dtypes, nothing allocated): a checkpoint's restore template.

The reference's fourth callable, ``state_specs``, places the state on a
mesh and waits for training placement (ROADMAP queue 1 item 9a).

Gradients: ``torch.autograd.grad`` of the family's ``loss_fn`` with
respect to the params (the model recomputes each layer's block in the
backward).  Gradient accumulation follows the reference's scan: each
microbatch's gradient is divided by ``grad_accum``, cast to
``grad_accum_dtype`` and summed in order; the metrics are the last
microbatch's.  The state is updated in place (see ``optimizer``).  No
``torch.compile``: the step runs eagerly.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import common as cm
from repro_torch.models.registry import Model
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, leaves, tree_map

Pytree = Any


def _refill(tree: Pytree, it) -> Pytree:
    """``tree``'s structure with its leaves taken from ``it`` in sorted-key
    order (the inverse of :func:`optimizer.leaves`)."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    return next(it)


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """numpy arrays (or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: Model, run: RunConfig):
    tc, pc = run.train, run.parallel
    opt = AdamW(tc, moment_dtype=getattr(torch, pc.optimizer_dtype))
    acc_dt = getattr(torch, pc.grad_accum_dtype)
    if pc.grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression {pc.grad_compression!r}")

    def init_state(seed: int = 0) -> Pytree:
        params = model.init(seed)
        state = {"params": params, "opt": opt.init(params)}
        if pc.grad_compression == "int8":
            state["err"] = compression.init_error(params)
        return state

    def state_shapes() -> Pytree:
        meta = torch.device("meta")
        dtype = cm.param_dtype(model.cfg)
        params = {}
        for path, defn in cm._leaves(model.param_defs):
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = torch.empty(defn.shape, dtype=dtype, device=meta)

        def like(dt):
            return tree_map(lambda p: torch.empty(p.shape, dtype=dt, device=meta), params)

        state = {"params": params,
                 "opt": {"m": like(opt.moment_dtype), "v": like(opt.moment_dtype),
                         "step": torch.empty((), dtype=torch.int32, device=meta)}}
        if pc.grad_compression == "int8":
            state["err"] = like(torch.float32)
        return state

    def grads_of(params: Pytree, batch: dict):
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(req, batch)
        # a leaf no layer reads (an empty (0, ...) stack) gets zeros, as in JAX
        grads = torch.autograd.grad(loss, leaves(req), allow_unused=True,
                                    materialize_grads=True)
        return {k: v.detach() for k, v in metrics.items()}, _refill(params, iter(grads))

    def compute_grads(params: Pytree, batch: dict):
        """-> (the last microbatch's metrics, the gradient tree); the
        reference's summed loss is unused by its step, so not kept."""
        n = pc.grad_accum
        if n <= 1:
            return grads_of(params, batch)
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device), params)
        for i in range(n):
            metrics, grads = grads_of(params, {k: v[i] for k, v in micro.items()})
            for a, g in zip(leaves(acc), leaves(grads), strict=True):
                a.add_((g / n).to(acc_dt))
            del grads
        return metrics, acc

    def train_step(state: Pytree, batch: dict):
        batch = to_device(batch, model.device)
        metrics, grads = compute_grads(state["params"], batch)
        new_state = dict(state)
        if pc.grad_compression == "int8":
            grads, new_state["err"] = compression.compress_grads(grads, state["err"])
        params, opt_state, opt_metrics = opt.update(grads, state["opt"], state["params"])
        new_state["params"] = params
        new_state["opt"] = opt_state
        return new_state, {**metrics, **opt_metrics}

    return init_state, train_step, state_shapes
