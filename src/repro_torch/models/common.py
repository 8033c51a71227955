"""Shared layers and parameter definitions (plain PyTorch).

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors; every family defines its tree once as :class:`ParamDef` leaves
and :func:`init_params` samples it; :func:`resolve_spec` and
:func:`resolve_param_spec` map a leaf's logical axes to the mesh axes it
is split over (a :class:`Spec`).  Layouts follow the JAX package
(weights ``(d_in, ..., d_out)``, activations ``(B, S, H, D)``) so the
tests compare like with like.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed import collectives

Pytree = Any


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | small | embed
    scale: float | None = None  # override fan-in scale

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _std(defn: ParamDef) -> float:
    """The reference's distribution (``repro.models.common._sample``):
    fan-in scaled normal, 0.02 for ``embed``, 1e-4 for ``small``."""
    if defn.init == "embed":
        return 0.02
    if defn.init == "small":
        return 1e-4
    fan_in = defn.shape[-2] if len(defn.shape) >= 2 else defn.shape[-1]
    return defn.scale if defn.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))


def _leaves(tree: Pytree, prefix: tuple = ()):
    """(path, ParamDef) pairs in sorted-key order (JAX's dict order)."""
    if isinstance(tree, ParamDef):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from _leaves(tree[key], prefix + (key,))


# a leaf of more elements is drawn one leading-axis slab at a time
SLAB_ELEMENTS = 1 << 30


def _fill_normal(dst: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``dst`` in place with an f32 normal draw times ``std``, cast to
    its dtype.  A destination above ``SLAB_ELEMENTS`` (an MoE expert
    stack: 8.7e9 elements at moonshot-v1-16b-a3b's width) is filled one
    leading-axis slab at a time, and a slab still above it (one layer of
    deepseek-v3-671b's: 256 x 7168 x 2048) one slab of its own leading
    axis at a time, so no f32 transient exceeds ``SLAB_ELEMENTS`` and no
    slab is staged outside ``dst``."""
    if dst.numel() <= SLAB_ELEMENTS or dst.dim() < 2:
        dst.copy_(torch.randn(dst.shape, generator=generator, device=dst.device,
                              dtype=torch.float32).mul_(std))
        return
    for slab in dst:
        _fill_normal(slab, std, generator)


def init_params(tree: Pytree, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device, take=None) -> Pytree:
    """Sample every ParamDef leaf from ``generator`` (a seeded
    ``torch.Generator`` on ``device``).  Same distributions as the
    reference; not the same numbers, since torch cannot reproduce
    ``jax.random``.  ``take(path, leaf)``, when given, keeps a part of
    each whole leaf (a rank's shard): every rank draws the same numbers."""
    out: dict = {}
    for path, defn in _leaves(tree):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if defn.init in ("zeros", "ones"):
            fill = torch.zeros if defn.init == "zeros" else torch.ones
            val = fill(defn.shape, dtype=dtype, device=device)
        else:
            val = torch.empty(defn.shape, dtype=dtype, device=device)
            _fill_normal(val, _std(defn), generator)
        node[path[-1]] = val if take is None else take(path, val)
    return out


def count_params(tree: Pytree) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(tree))


def map_defs(fn, tree: Pytree) -> Pytree:
    """``fn`` applied to every ParamDef leaf of ``tree``, the nesting kept."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    return {k: map_defs(fn, v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# logical -> mesh spec resolution (``repro.models.common``'s resolver)
# ---------------------------------------------------------------------------
class Spec(tuple):
    """The port's ``PartitionSpec``: one entry per leading dim, each None
    (whole), a mesh-axis name, or a tuple of them (the dim split over their
    product, the first axis major); trailing whole dims are dropped."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over (``()`` when whole)."""
        part = self[dim] if dim < len(self) else None
        if part is None:
            return ()
        return part if isinstance(part, tuple) else (part,)

    def without(self, axes: tuple[str, ...]) -> "Spec":
        """This spec with the mesh axes ``axes`` taken out of every dim."""
        parts = []
        for d in range(len(self)):
            kept = tuple(a for a in self.axes(d) if a not in axes)
            parts.append(None if not kept else kept[0] if len(kept) == 1 else kept)
        while parts and parts[-1] is None:
            parts.pop()
        return Spec(*parts)

    def split_axes(self) -> tuple[str, ...]:
        """Every mesh axis this spec splits a dim over."""
        return tuple(a for d in range(len(self)) for a in self.axes(d))


# default rules; core.placement builds policy-specific variants
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "kv_batch": ("pod", "data"),
    "kv_seq": (),
    "embed": (),
    "head_dim": (),
    "seq": (),
    "layers": (),
    "state": (),
}


def resolve_spec(logical: tuple[str | None, ...], rules: dict[str, tuple[str, ...]],
                 mesh_axes: dict[str, int], shape: tuple[int, ...] | None = None) -> Spec:
    """Map logical axes to a :class:`Spec`: each named axis takes the mesh
    axes its rule lists that the mesh has, a mesh axis at most once over
    all dims.  With ``shape``, an axis that would not divide its dim evenly
    (with the axes kept before it) is dropped."""
    parts: list[Any] = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        if name is None or name not in rules:
            parts.append(None)
            continue
        axes = tuple(a for a in rules[name] if a in mesh_axes and a not in used)
        if shape is not None:
            kept, prod = [], 1
            for a in axes:
                if shape[i] > 0 and shape[i] % (prod * mesh_axes[a]) == 0:
                    kept.append(a)
                    prod *= mesh_axes[a]
            axes = tuple(kept)
        if not axes:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return Spec(*parts)


def _spec_axes(spec: Spec) -> set[str]:
    return {a for i in range(len(spec)) for a in spec.axes(i)}


def resolve_param_spec(defn: ParamDef, rules: dict[str, tuple[str, ...]],
                       mesh_axes: dict[str, int]) -> Spec:
    """:func:`resolve_spec` with the reference's row-parallel fallback: a
    weight of 2^20 elements or more that loses its ``model`` split to
    divisibility is split over ``model`` on its first ``embed``, ``mlp``
    or ``vocab`` dim that divides instead."""
    spec = resolve_spec(defn.logical, rules, mesh_axes, defn.shape)
    if "model" not in mesh_axes or math.prod(defn.shape) < (1 << 20):
        return spec
    if "model" in _spec_axes(spec):
        return spec
    parts = list(spec) + [None] * (len(defn.shape) - len(spec))
    for i, name in enumerate(defn.logical):
        if (name in ("embed", "mlp", "vocab") and parts[i] is None
                and defn.shape[i] % mesh_axes["model"] == 0):
            parts[i] = "model"
            while parts and parts[-1] is None:
                parts.pop()
            return Spec(*parts)
    return spec


def specs_for(defs: Pytree, rules: dict[str, tuple[str, ...]], mesh_axes: dict[str, int],
              params: bool = False) -> Pytree:
    """The :class:`Spec` of every ParamDef leaf (``params``: with the
    weights' fallback, :func:`resolve_param_spec`)."""
    if params:
        return map_defs(lambda d: resolve_param_spec(d, rules, mesh_axes), defs)
    return map_defs(lambda d: resolve_spec(d.logical, rules, mesh_axes, d.shape), defs)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh (``launch.mesh.DeviceMesh``)."""
    return dict(zip(mesh.axis_names, mesh.shape))


# ---------------------------------------------------------------------------
# core layers
# ---------------------------------------------------------------------------
def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of the reference's f32 casts for ``x``: f32, widened to
    f64 for an f64 tensor (a float64 model then runs in f64 throughout,
    as the train path's conditioning check compares it with the reference
    under x64 with the same casts widened)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm that scales by ``1 + scale`` (zero-initialised scales)."""
    x32 = x.to(acc_dtype(x))
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(x32.dtype))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with a scale and a bias, in f32: the population variance
    (``jnp.var``'s, ``correction=0``)."""
    x32 = x.to(acc_dtype(x))
    var, mu = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(x32.dtype) + bias.to(x32.dtype)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half split.  x: (..., S, H, D), positions: (..., S)."""
    half, dt = x.shape[-1] // 2, acc_dtype(x)
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=dt, device=x.device) / half
    )
    ang = positions.to(dt)[..., None] * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(dt), x[..., half:].to(dt)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the trailing ``n_in`` dims of ``x`` with the leading
    ``n_in`` dims of ``w`` (the einsums ``...d,d...->...`` of the
    reference)."""
    k = math.prod(w.shape[:n_in])
    out = x.reshape(*x.shape[: x.dim() - n_in], k) @ w.reshape(k, -1)
    return out.reshape(*x.shape[: x.dim() - n_in], *w.shape[n_in:])


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor,
            true_vocab: int | None = None) -> torch.Tensor:
    """x (..., d_model), table (vocab_padded, d_model) -> logits.  Pad
    logits past ``true_vocab`` are set to -1e30."""
    logits = x @ table.t()
    if true_vocab is not None and true_vocab < table.shape[0]:
        logits[..., true_vocab:] = -1e30
    return logits


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in f32.  logits (B, S, V), targets (B, S).

    The reference's form: the max is detached, and the gold logit is taken
    by an iota-compare-select sum, not a gather (whose CUDA backward
    scatters with float atomics, so reruns would differ)."""
    logits32 = logits.to(acc_dtype(logits))
    m = logits32.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == targets[..., None], logits32, 0.0).sum(dim=-1)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(logits32.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 mask: torch.Tensor | None, v0: int, vocab_group,
                                 rows_group) -> torch.Tensor:
    """:func:`cross_entropy_loss` of logits split over the vocabulary and
    rows split over the batch, as the reference computes it with its
    logits kept split over ``vocab``: ``logits (b, S, v)`` are this
    rank's columns ``[v0, v0 + v)`` of its rows, ``targets`` / ``mask``
    its rows.  The detached maximum is reduced (MAX) over ``vocab_group``,
    the sum of exponentials and the gold logit (taken by the same
    iota-compare-select sum) are summed over it, and the masked sum is
    divided by the global count (the mask summed over ``rows_group``);
    the rows' partial losses are summed over ``rows_group``.  Every rank
    returns the whole batch's loss; the sums' backwards are the identity
    (``collectives.reduce_from``), so each rank's gradient is that of its
    columns and rows."""
    logits32 = logits.to(acc_dtype(logits))
    m = logits32.amax(dim=-1, keepdim=True).detach().clone()
    m = collectives.all_reduce_max(m, vocab_group)
    sumexp = collectives.reduce_from(torch.exp(logits32 - m).sum(dim=-1), vocab_group)
    logz = torch.log(sumexp) + m[..., 0]
    iota = torch.arange(v0, v0 + logits.shape[-1], device=logits.device)
    gold = collectives.reduce_from(
        torch.where(iota == targets[..., None], logits32, 0.0).sum(dim=-1), vocab_group)
    nll = logz - gold
    if mask is None:
        count = torch.tensor(float(nll.numel()), dtype=nll.dtype, device=nll.device)
        total = nll.sum()
    else:
        mask = mask.to(logits32.dtype)
        count, total = mask.sum(), (nll * mask).sum()
    count = collectives.all_reduce(count, rows_group).clamp_min(1.0)
    return collectives.reduce_from(total / count, rows_group)


def unstack(tree: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Stacked ``(L, ...)`` leaves -> one dict of slices per layer, through
    ``unbind``: under autograd each stacked leaf then takes its gradient
    from its layers' slices in one stack, not one full-size scatter per
    layer."""
    parts = {k: v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values()), ()))
    return [{k: p[l] for k, p in parts.items()} for l in range(n)]


# time steps per recomputed chunk of a train scan (the reference's chunk)
SCAN_REMAT_CHUNK = 256


def scan_in_chunks(steps, state: torch.Tensor, xs: list[torch.Tensor],
                   chunk: int = SCAN_REMAT_CHUNK):
    """``steps(state, *xs) -> (ys, state)`` over time-major ``xs`` (S
    leading), with the reference's remat over time: when ``S > chunk`` and
    ``chunk`` divides S, chunk by chunk, each chunk recomputed in the
    backward (:func:`remat`), so autograd keeps only the states at chunk
    boundaries; otherwise all S steps at once."""
    S = xs[0].shape[0]
    if S <= chunk or S % chunk:
        return steps(state, *xs)
    ys = []
    for c0 in range(0, S, chunk):
        y, state = remat(steps, state, *(x[c0:c0 + chunk] for x in xs))
        ys.append(y)
    return torch.cat(ys), state


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward: the
    reference's per-block ``jax.checkpoint`` with ``nothing_saveable``
    (non-reentrant ``torch.utils.checkpoint``; the block draws no random
    numbers, so no RNG state is kept)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)
