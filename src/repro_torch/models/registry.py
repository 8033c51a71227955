"""Model API: ``build_model(cfg, device, env, mesh)`` -> :class:`Model`.

Counterpart of ``repro.models.registry`` for all six families: dense,
MoE, DeepSeek, RWKV6, Zamba2 and the encoder-decoder.  A Model binds a
config and a device to the family's step functions and its training
``loss_fn`` (every family trains); the steps a family does not define
are None.  The device
is CUDA unless the caller asks for another (``device="cpu"``); with no
GPU and no explicit device, :func:`build_model` raises.

With an ``Env`` whose ``axes`` are not empty and the mesh of this rank
(``launch.mesh.DeviceMesh``), the model is placed: ``param_specs`` and
``cache_specs`` / ``paged_cache_specs`` resolve the reference's rules,
:meth:`Model.init` keeps this rank's shard of every weight,
``init_cache`` allocates a ``core.offload.ShardedCache`` and
``init_paged_cache`` a ``core.offload.ShardedPool`` (the host tier
included), and the dense family's ``prefill`` (with a frontend's
``embeds``), ``decode_step``, ``decode_sample_step``, chunked
``prefill_step`` / ``prefill_sample_step``, ``paged_decode_step`` /
``paged_decode_sample_step`` and speculation's ``verify_step`` /
``paged_verify_step`` run tensor parallel on them, on the bf16/f32 cache
and on the int8 ``kv_quant`` one, as its ``loss_fn`` does for training
(``training.trainer`` reduces the gradients and shards the optimizer
state).  The other families wait for later slices (:func:`build_model`
refuses them on a mesh).

A serving cluster builds each replica's model on the replica's own mesh
(``launch.mesh.replica_meshes``), placed there or, for a mesh of one
rank, on that rank alone; on every rank outside the mesh the same call
gives a *stand-in* (:attr:`Model.mirror`): the model's config and steps
with no device state (:meth:`Model.init` gives no weights), which lets
the replica's engine keep the replica's host bookkeeping there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import DEEPSEEK, DENSE, ENCDEC, MOE, RWKV6, ZAMBA2, ModelConfig
from repro_torch.core.offload import Placement
from repro_torch.core.placement import Env, kv_rules
from repro_torch.device import resolve_device
from repro_torch.models import common as cm

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    param_defs: Pytree
    # prefill(params, tokens (B, S), cache, embeds=None) -> (logits (B, V), cache)
    prefill: Callable[..., tuple[torch.Tensor, Pytree]]
    # decode_step(params, cache, tokens (B,)) -> (logits (B, V), cache)
    decode_step: Callable[..., tuple[torch.Tensor, Pytree]]
    cache_defs: Callable[[int, int], Pytree]
    init_cache: Callable[..., Pytree]
    # loss_fn(params, batch) -> (loss, metrics): the train step's objective
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    # The steps below are None for a family without them (the MoE,
    # DeepSeek, RWKV6, Zamba2 and encoder-decoder families have none), as
    # in the reference.
    # decode_sample_step(params, cache, tokens, generator, eos_ids, *, sampler)
    #   -> (tokens' (B,), eos_hit (B,), cache)
    decode_sample_step: Callable[..., tuple[torch.Tensor, ...]] | None = None
    # chunked prefill: prefill_step(params, cache, tokens (1, C), slot,
    #   q_offset, n_valid) -> (logits (1, V), cache), slot/q_offset/n_valid
    #   (1,) int32 device tensors or host ints; prefill_sample_step(...,
    #   n_valid, generator, *, sampler)
    #   -> (token (1,), cache)
    prefill_step: Callable[..., tuple[torch.Tensor, Pytree]] | None = None
    prefill_sample_step: Callable[..., tuple[torch.Tensor, Pytree]] | None = None
    # paged pool: (n_slots, n_blocks, block_size, max_blocks, *, kv_dtype,
    # host_blocks) -> cache; paged_decode_step / paged_decode_sample_step
    # as decode_step / decode_sample_step, against the pool
    paged_cache_defs: Callable[..., Pytree] | None = None
    init_paged_cache: Callable[..., Pytree] | None = None
    paged_decode_step: Callable[..., tuple[torch.Tensor, Pytree]] | None = None
    paged_decode_sample_step: Callable[..., tuple[torch.Tensor, ...]] | None = None
    # speculative verify: verify_step(params, cache, tokens (B, T)) ->
    #   (logits (B, T, V), cache), lengths returned unchanged;
    #   paged_verify_step the same against the pool
    verify_step: Callable[..., tuple[torch.Tensor, Pytree]] | None = None
    paged_verify_step: Callable[..., tuple[torch.Tensor, Pytree]] | None = None
    env: Env = dataclasses.field(default_factory=Env)
    # this rank on the mesh, when ``env.axes`` is not empty
    placement: Placement | None = None
    # the mesh whose ranks hold the model's device state (launch.mesh's
    # DeviceMesh; None: this process alone)
    mesh: Any = None

    @property
    def mirror(self) -> bool:
        """Whether this rank is outside the model's mesh: a stand-in with no
        device state."""
        return self.mesh is not None and self.mesh.coords is None

    def init(self, seed: int = 0) -> Pytree:
        """Random weights from a seeded generator on the model's device; on
        a mesh every rank draws the whole of each leaf, the same numbers as
        one device, and keeps its shard.  A stand-in has none (None)."""
        if self.mirror:
            return None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        take = None
        if self.placement is not None:
            specs = self.param_specs()

            def take(path, leaf):
                spec = specs
                for key in path:
                    spec = spec[key]
                return self.placement.take(leaf, spec).clone()
        return cm.init_params(self.param_defs, gen, cm.param_dtype(self.cfg), self.device,
                              take=take)

    def param_specs(self) -> Pytree:
        """Every weight's :class:`~repro_torch.models.common.Spec` on the
        mesh (the reference's ``param_rules`` with the row-parallel
        fallback)."""
        return cm.specs_for(self.param_defs, self.env.param_rules(), self.env.axes,
                            params=True)

    def cache_specs(self, batch: int, max_seq: int) -> Pytree:
        """Every dense cache leaf's Spec under the KV policy."""
        return cm.specs_for(self.cache_defs(batch, max_seq), kv_rules(self.env.policy()),
                            self.env.axes)

    def paged_cache_specs(self, n_slots: int, n_blocks: int, block_size: int,
                          max_blocks: int, **kw) -> Pytree:
        """Every paged pool leaf's Spec under the KV policy: the block axis
        split across the HPU lanes by the ``kv_blocks`` rule.  ``kw``
        (``kv_dtype``, ``host_blocks``) passes through to
        ``paged_cache_defs``."""
        if self.paged_cache_defs is None:
            raise ValueError(f"{self.cfg.family} has no paged cache")
        return cm.specs_for(self.paged_cache_defs(n_slots, n_blocks, block_size, max_blocks,
                                                  **kw),
                            kv_rules(self.env.policy()), self.env.axes)

    def n_params(self) -> int:
        return cm.count_params(self.param_defs)


# the steps a family may lack; a family opts in by defining them
OPTIONAL_STEPS = ("decode_sample_step", "prefill_step", "prefill_sample_step",
                  "paged_cache_defs", "paged_decode_step", "paged_decode_sample_step",
                  "verify_step", "paged_verify_step")


def build_model(cfg: ModelConfig, device: str | torch.device | None = None,
                env: Env | None = None, mesh=None) -> Model:
    """``cfg``'s model on ``device``; with ``env.axes``, placed on this
    rank of ``mesh``.  ``mesh`` without axes (a replica's mesh of one rank)
    names the rank that holds the model.  On a rank outside ``mesh`` the
    model is a stand-in (:attr:`Model.mirror`)."""
    dev = resolve_device(device)
    env = env or Env()
    if cfg.family == DENSE:
        from repro_torch.models import dense as fam
    elif cfg.family == MOE:
        from repro_torch.models import moe as fam
    elif cfg.family == DEEPSEEK:
        from repro_torch.models import deepseek as fam
    elif cfg.family == RWKV6:
        from repro_torch.models import rwkv6 as fam
    elif cfg.family == ZAMBA2:
        from repro_torch.models import zamba2 as fam
    elif cfg.family == ENCDEC:
        from repro_torch.models import encdec as fam
    else:
        raise ValueError(f"unknown family {cfg.family}")
    defs = fam.param_defs(cfg)
    if env.axes:
        return _placed_model(cfg, dev, env, mesh, fam, defs)
    if mesh is not None and len(mesh.ranks) != 1:
        raise ValueError(f"an unplaced model lives on one rank, not on {mesh}")
    optional = {name: functools.partial(getattr(fam, name), cfg)
                for name in OPTIONAL_STEPS if hasattr(fam, name)}
    if hasattr(fam, "init_paged_cache"):
        optional["init_paged_cache"] = functools.partial(fam.init_paged_cache, cfg, device=dev)
    return Model(
        cfg=cfg,
        device=dev,
        param_defs=defs,
        prefill=functools.partial(fam.prefill, cfg),
        decode_step=functools.partial(fam.decode_step, cfg),
        cache_defs=functools.partial(fam.cache_defs, cfg),
        init_cache=functools.partial(fam.init_cache, cfg, device=dev),
        loss_fn=functools.partial(fam.loss_fn, cfg),
        env=env,
        mesh=mesh,
        **optional,
    )


def _placed_model(cfg: ModelConfig, dev: torch.device, env: Env, mesh, fam, defs) -> Model:
    """The dense family on a mesh: its serving steps (dense cache and
    paged pool, whole and chunked prefill, verify) and its training
    ``loss_fn`` bound to this rank's :class:`Placement`."""
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"placement serves the dense family only; {cfg.family} waits for a later slice "
            "(ROADMAP item 9b: the other families serving on a mesh)")
    if mesh is None or dict(zip(mesh.axis_names, mesh.shape)) != dict(env.axes):
        raise ValueError(f"a placed model needs this rank's mesh of axes {env.axes}, got {mesh}")
    specs = cm.specs_for(defs, env.param_rules(), env.axes, params=True)
    fam.tensor_parallel(specs)                  # raises for a layout it does not run
    place = Placement(env, mesh, specs)
    return Model(
        cfg=cfg,
        device=dev,
        param_defs=defs,
        prefill=functools.partial(fam.prefill, cfg, place=place),
        decode_step=functools.partial(fam.decode_step, cfg, place=place),
        cache_defs=functools.partial(fam.cache_defs, cfg),
        init_cache=functools.partial(fam.init_cache, cfg, device=dev, place=place),
        loss_fn=functools.partial(fam.loss_fn, cfg, place=place),
        decode_sample_step=functools.partial(fam.decode_sample_step, cfg, place=place),
        prefill_step=functools.partial(fam.prefill_step, cfg, place=place),
        prefill_sample_step=functools.partial(fam.prefill_sample_step, cfg, place=place),
        paged_cache_defs=functools.partial(fam.paged_cache_defs, cfg),
        init_paged_cache=functools.partial(fam.init_paged_cache, cfg, device=dev, place=place),
        paged_decode_step=functools.partial(fam.paged_decode_step, cfg, place=place),
        paged_decode_sample_step=functools.partial(fam.paged_decode_sample_step, cfg,
                                                   place=place),
        verify_step=functools.partial(fam.verify_step, cfg, place=place),
        paged_verify_step=functools.partial(fam.paged_verify_step, cfg, place=place),
        env=env,
        placement=place,
        mesh=mesh,
    )
