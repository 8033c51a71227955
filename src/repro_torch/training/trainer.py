"""The train step, made by ``make_train_step``.

Counterpart of ``repro.training.trainer``.  ``make_train_step(model,
run_cfg)`` returns the reference's four callables, in its order:
  * ``init_state(seed)`` — the TrainState tree: ``params``, ``opt`` (AdamW
    ``m``, ``v`` and an int32 ``step``) and, under int8 gradient
    compression, ``err`` (the f32 error-feedback residual);
  * ``train_step(state, batch) -> (state, metrics)``; ``batch`` holds numpy
    arrays or tensors (``inputs``, ``targets``, ``mask``), moved to the
    model's device here;
  * ``state_specs()`` — the :class:`~repro_torch.models.common.Spec` of
    every leaf on the mesh: ``params`` the model's param specs, ``m``,
    ``v`` and ``err`` the ZeRO specs (``param_rules(fsdp=True)`` when
    ``zero_stage >= 1`` or ``Env.fsdp``: d_model over the batch axes even
    where the params are not split so), ``step`` replicated;
  * ``state_shapes()`` — the whole state's tree as tensors on the ``meta``
    device (shapes and dtypes, nothing allocated): a checkpoint's restore
    template.

Gradients: ``torch.autograd.grad`` of the family's ``loss_fn`` with
respect to the params (the model recomputes each layer's block in the
backward).  Gradient accumulation follows the reference's scan: each
microbatch's gradient is divided by ``grad_accum``, cast to
``grad_accum_dtype`` and summed in order; the metrics are the last
microbatch's.  The state is updated in place (see ``optimizer``).  No
``torch.compile``: the step runs eagerly.

On a mesh (a placed model) every rank holds its shards: ``init_state``
allocates only them.  The placed ``loss_fn`` takes the global batch and
computes on this rank's rows; each gradient leaf comes back partial over
the batch axes its param is not split over, and is reduced over them
into its ZeRO shard (a reduce-scatter; once per microbatch under
accumulation, the reference's ``constrain_grads``, so the f32
accumulator is a shard too).  int8 compression and AdamW then run on the
ZeRO shards (the clip's norm and the int8 amax reduced over each leaf's
split axes), and each updated param shard is gathered back over the axes
ZeRO split and the params are not.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.placement import param_rules
from repro_torch.distributed import collectives
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


# the mesh axes the rows of a batch are split over (ZeRO's axes)
BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class _Zero:
    """How one param leaf's gradient reaches its ZeRO shard on this rank:
    ``pending`` is the group of the batch axes the gradient is still
    partial over (None: none); ZeRO splits dim ``dim`` further over
    ``extra`` (its group; None: the ZeRO shard is the param shard), this
    rank's part ``[lo, hi)`` of the param shard's dim; ``split`` is the
    group of every axis the ZeRO spec splits."""
    pending: object
    scatter: bool            # pending's axes are exactly extra's: a reduce-scatter
    dim: int | None
    extra: object
    lo: int
    hi: int
    split: object


def _zero_plan(place, pspec: cm.Spec, zspec: cm.Spec, shape) -> _Zero:
    mesh = place.mesh
    order = mesh.axis_names
    live = [a for a in BATCH_AXES if mesh.size_of(a) > 1]
    pending = tuple(a for a in live if a not in pspec.split_axes())
    dims = []
    for d, n in enumerate(shape):
        p_ax, z_ax = pspec.axes(d), zspec.axes(d)
        if z_ax[:len(p_ax)] != p_ax:
            raise NotImplementedError(f"ZeRO spec {zspec} does not refine the param spec {pspec}")
        extra = mesh._live(z_ax[len(p_ax):])
        if extra:
            dims.append((d, extra, place.part(z_ax, n), place.part(p_ax, n)))
    if len(dims) > 1 or any(a not in pending for _, ex, _, _ in dims for a in ex):
        raise NotImplementedError(f"ZeRO spec {zspec} against the param spec {pspec}")
    split = tuple(sorted(set(zspec.split_axes()), key=order.index))
    if not dims:
        return _Zero(mesh.group(pending), False, None, None, 0, 0, mesh.group(split))
    d, extra, (z0, z1), (p0, _) = dims[0]
    return _Zero(mesh.group(pending), tuple(extra) == mesh._live(pending), d,
                 mesh.group(extra), z0 - p0, z1 - p0, mesh.group(split))


def _reduce_to_zero(g: torch.Tensor, z: _Zero) -> torch.Tensor:
    """A gradient shard, partial over ``z.pending``, summed over it into
    this rank's ZeRO shard."""
    if z.pending is None:
        return g
    if z.scatter:
        return collectives.reduce_scatter(g, z.pending, z.dim)
    g = collectives.all_reduce(g.contiguous().clone(), z.pending)
    return g if z.dim is None else g.narrow(z.dim, z.lo, z.hi - z.lo).contiguous()


def make_train_step(model: Model, run: RunConfig):
    tc, pc = run.train, run.parallel
    opt = AdamW(tc, moment_dtype=getattr(torch, pc.optimizer_dtype))
    acc_dt = getattr(torch, pc.grad_accum_dtype)
    if pc.grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression {pc.grad_compression!r}")
    env, place = model.env, model.placement
    zrules = param_rules(env.sequence_parallel, fsdp=(pc.zero_stage >= 1 or env.fsdp))
    zspecs = cm.specs_for(model.param_defs, zrules, env.axes, params=True)

    @functools.cache
    def zero_plans():
        """Each leaf's :class:`_Zero` and its group of split axes (made at
        the first step: the groups are the mesh's)."""
        plans = _plans(place, model.param_defs, model.param_specs(), zspecs)
        return plans, tree_map(lambda z: z.split, plans)

    def init_state(seed: int = 0) -> Pytree:
        params = model.init(seed)
        if place is None:
            state = {"params": params, "opt": opt.init(params)}
            if pc.grad_compression == "int8":
                state["err"] = compression.init_error(params)
            return state

        def zeros(dtype):
            """This rank's ZeRO shard of every leaf, zeroed."""
            return _zero_shards(place, model.param_defs, zspecs, dtype, model.device)

        state = {"params": params,
                 "opt": {"m": zeros(opt.moment_dtype), "v": zeros(opt.moment_dtype),
                         "step": torch.zeros((), dtype=torch.int32, device=model.device)}}
        if pc.grad_compression == "int8":
            state["err"] = zeros(torch.float32)
        return state

    def state_specs() -> Pytree:
        specs = {"params": model.param_specs(),
                 "opt": {"m": zspecs, "v": zspecs, "step": cm.Spec()}}
        if pc.grad_compression == "int8":
            specs["err"] = zspecs
        return specs

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
        """-> (metrics, the gradient tree), on a mesh each leaf reduced into
        its ZeRO shard."""
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(req, batch)
        # a leaf no layer reads (an empty (0, ...) stack) gets zeros, as in JAX
        grads = torch.autograd.grad(loss, leaves(req), allow_unused=True,
                                    materialize_grads=True)
        grads = _refill(params, iter(grads))
        if place is not None:
            grads = tree_map(_reduce_to_zero, grads, zero_plans()[0])
        return {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(params: Pytree, batch: dict):
        """-> (the last microbatch's metrics, the gradient tree); the
        reference's summed loss is unused by its step, so not kept."""
        n = pc.grad_accum
        if n <= 1:
            return grads_of(params, batch)
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        acc = None
        for i in range(n):
            metrics, grads = grads_of(params, {k: v[i] for k, v in micro.items()})
            if acc is None:
                acc = tree_map(lambda g: torch.zeros(g.shape, dtype=acc_dt, device=g.device),
                               grads)
            for a, g in zip(leaves(acc), leaves(grads), strict=True):
                a.add_((g / n).to(acc_dt))
            del grads
        return metrics, acc

    def train_step(state: Pytree, batch: dict):
        batch = to_device(batch, model.device)
        metrics, grads = compute_grads(state["params"], batch)
        new_state = dict(state)
        params, plans, groups = state["params"], None, None
        if place is not None:
            # the ZeRO shard of each param (a copy where it is not a
            # contiguous part): updated in place, then gathered back
            plans, groups = zero_plans()
            params = tree_map(lambda p, z: p if z.dim is None else
                              p.narrow(z.dim, z.lo, z.hi - z.lo).contiguous(), params, plans)
        if pc.grad_compression == "int8":
            grads, new_state["err"] = compression.compress_grads(grads, state["err"], groups)
        params, opt_state, opt_metrics = opt.update(grads, state["opt"], params, groups)
        if place is not None:
            with torch.no_grad():
                tree_map(_gather_back, state["params"], params, plans)
            params = state["params"]
        new_state["params"] = params
        new_state["opt"] = opt_state
        return new_state, {**metrics, **opt_metrics}

    return init_state, train_step, state_specs, state_shapes


def _plans(place, defs: Pytree, pspecs: Pytree, zspecs: Pytree) -> Pytree:
    if isinstance(defs, dict):
        return {k: _plans(place, defs[k], pspecs[k], zspecs[k]) for k in defs}
    return _zero_plan(place, pspecs, zspecs, defs.shape)


def _zero_shards(place, defs: Pytree, zspecs: Pytree, dtype: torch.dtype, device) -> Pytree:
    """Zeros of this rank's ZeRO shard of every leaf, allocated at the
    shard's shape."""
    if isinstance(defs, dict):
        return {k: _zero_shards(place, defs[k], zspecs[k], dtype, device) for k in defs}
    return torch.zeros(place.local_shape(zspecs, defs.shape), dtype=dtype, device=device)


def _gather_back(p: torch.Tensor, p_z: torch.Tensor, z: _Zero) -> None:
    """Write the updated ZeRO shard ``p_z`` of ``p`` back: gathered over
    the axes ZeRO split and the params are not."""
    if z.dim is not None:
        p.copy_(collectives.all_gather(p_z, z.extra, z.dim))
