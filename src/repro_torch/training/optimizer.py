"""AdamW + LR schedules: cosine, constant, and WSD (warmup-stable-decay),
the MiniCPM schedule the minicpm-2b config calls for.

Counterpart of ``repro.training.optimizer``: the same f32 arithmetic in
the same order (global-norm clip in f32, bias corrections, decoupled
weight decay on the f32 param, the cast back to the param's dtype,
moments in ``moment_dtype``, an int32 step).  The port updates params
and moments **in place** (the reference's trainer donates its state to
the jitted step instead), one slab of at most ``SLAB`` elements at a time:
the update is elementwise, so slabs give the whole leaf's bits while the
f32 temporaries stay small beside a full-width state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import collectives

Pytree = Any

SLAB = 1 << 26


def leaves(tree: Pytree) -> list[torch.Tensor]:
    """Leaves in sorted-key order (``jax.tree.leaves``' order for dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def leaves_of(tree: Pytree, like: Pytree) -> list:
    """The leaves of ``tree`` (any values) in ``like``'s sorted-key order."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaves_of(tree[k], like[k])]
    return [tree]


def tree_map(fn, tree: Pytree, *rest: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def make_schedule(tc: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (f32 tensor) -> learning rate (f32 tensor)."""
    warm, total = tc.warmup_steps, tc.total_steps

    def cosine(step):
        frac = ((step - warm) / max(total - warm, 1)).clamp(0.0, 1.0)
        return tc.lr * torch.where(step < warm, step / max(warm, 1),
                                   0.5 * (1.0 + torch.cos(math.pi * frac)))

    def const(step):
        return tc.lr * torch.clamp(step / max(warm, 1), max=1.0)

    def wsd(step):
        """Warmup-Stable-Decay (MiniCPM): flat until stable_frac, then a
        fast exponential-ish (cosine-tail) decay to 10% of peak."""
        stable_end = warm + (total - warm) * tc.stable_frac
        decay_frac = ((step - stable_end) / max(total - stable_end, 1)).clamp(0.0, 1.0)
        decay = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * decay_frac))
        return tc.lr * torch.where(step < warm, step / max(warm, 1),
                                   torch.where(step < stable_end, 1.0, decay))

    return {"cosine": cosine, "const": const, "wsd": wsd}[tc.schedule]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _slabs(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), SLAB):
        yield flat[i:i + SLAB]


@dataclasses.dataclass(frozen=True)
class AdamW:
    tc: TrainConfig
    moment_dtype: torch.dtype = torch.float32

    def init(self, params: Pytree) -> Pytree:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)

        device = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Pytree, opt_state: Pytree, params: Pytree, groups: Pytree = None):
        """-> (params, opt_state, {"lr", "grad_norm"}): params, ``m`` and
        ``v`` are the trees passed in, updated in place; the step is a new
        tensor.  On a mesh the trees are this rank's shards and ``groups``
        (a tree like them) gives each leaf's process group of the axes
        that split it (None: whole): the clip's sum of squares of a leaf
        is summed over its group, so a split leaf counts every shard once
        and a replicated leaf counts once."""
        tc = self.tc
        step = opt_state["step"] + 1
        stepf = step.float()
        lr = make_schedule(tc)(stepf)

        # global-norm clip in f32: per-leaf sums added in leaf order
        sqs = [g.float().square().sum() for g in leaves(grads)]
        if groups is not None:
            # one all-reduce per group, of its leaves' sums stacked
            by_group: dict[int, tuple[object, list[int]]] = {}
            for i, grp in enumerate(leaves_of(groups, grads)):
                if grp is not None:
                    by_group.setdefault(id(grp), (grp, []))[1].append(i)
            for grp, idx in by_group.values():
                summed = collectives.all_reduce(torch.stack([sqs[i] for i in idx]), grp)
                for j, i in enumerate(idx):
                    sqs[i] = summed[j]
        gsq = sum(sqs)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

        b1, b2 = tc.b1, tc.b2
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)

        def upd(g, m, v, p):
            g = g.float() * scale
            m32, v32 = m.float(), v.float()
            m_new = b1 * m32 + (1 - b1) * g
            v_new = b2 * v32 + (1 - b2) * torch.square(g)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + tc.eps) + tc.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)

        for g, m, v, p in zip(leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]),
                              leaves(params), strict=True):
            if not (m.is_contiguous() and v.is_contiguous() and p.is_contiguous()):
                raise ValueError("AdamW.update updates contiguous params and moments in place")
            for slabs in zip(_slabs(g), _slabs(m), _slabs(v), _slabs(p)):
                upd(*slabs)
        new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
        return params, new_state, {"lr": lr, "grad_norm": gnorm}
