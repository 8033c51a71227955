"""The collectives the placed model writes out, over ``torch.distributed``.

Where the reference lets GSPMD insert collectives, the port calls these
on a mesh axis group (``launch.mesh.DeviceMesh.group``; ``None`` is a
group of one rank, and every function then returns its input).  gloo
carries ``all_reduce`` and ``broadcast`` on CUDA tensors but not
``all_gather`` (the case of two ranks sharing one card), so there a
gather is built from ``all_reduce``: each rank writes its part into a
zeroed slot of a stacked buffer and the sum is the gather, exactly (a
value plus zeros is that value).  The route is chosen from the group's
backend and the tensor's device, never by catching an error.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_by_sum(backend: str, x: torch.Tensor) -> bool:
    """Whether ``backend`` lacks ``all_gather`` for a tensor on ``x``'s
    device: gloo on a CUDA tensor."""
    return backend == "gloo" and x.is_cuda


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in group-rank order: ``(n, *x.shape)``."""
    if group is None:
        return x[None]
    x = x.contiguous()
    if _gather_by_sum(dist.get_backend(group), x):
        return _stack_by_sum(x, group)
    out = x.new_empty((dist.get_world_size(group), *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def _stack_by_sum(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_stack` from ``all_reduce``: this rank's ``x`` in its
    slot of a zeroed stack, summed over the group (``group`` None: the
    default group)."""
    buf = x.new_zeros((dist.get_world_size(group), *x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    return torch.cat(gather_stack(x, group).unbind(0), dim=dim)
