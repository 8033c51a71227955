"""The collectives the placed model writes out, over ``torch.distributed``.

Where the reference lets GSPMD insert collectives, the port calls these
on a mesh axis group (``launch.mesh.DeviceMesh.group``; ``None`` is a
group of one rank, and every function then returns its input).  gloo
carries ``all_reduce`` and ``broadcast`` on CUDA tensors but not
``all_gather``, ``reduce_scatter`` or send / receive (the case of two
ranks sharing one card), and has no reduce-scatter at all, so:

* a send / receive of a CUDA tensor over gloo goes through pinned host
  memory (:func:`shift`: one device-to-host copy, the send, and one
  host-to-device copy);
* a gather of CUDA tensors over gloo is the ring algorithm of ``n - 1``
  such steps (:func:`_ring_gather`), and a reduce-scatter over gloo the
  ring of ``n - 1`` steps that each add a received part
  (:func:`_ring_reduce_scatter`): each rank sends ``(n - 1) / n`` of the
  data; an all-reduce of CUDA tensors over gloo is the ring gather and a
  sum (:func:`_ring_all_reduce`).  On two ranks sharing an H100 they took half the time of an
  ``all_reduce`` of a zeroed stack and of an ``all_reduce`` and a slice
  at 1 MB to 1.2 GB per rank (``scripts/torch_gloo_collectives.py``).

The route is chosen from the group's backend and the tensor's device,
never by catching an error.

The train step's backward needs every collective of its forward to have
its transpose: :class:`CopyToGroup`, :class:`ReduceFromGroup`,
:class:`GatherFromGroup`, :class:`ScatterToGroup` and :class:`Shift` are
the differentiable forms (``torch.autograd.Function``), in the pairs of
Megatron's tensor parallelism and of ZeRO-3.  :func:`int8_psum` and
:func:`collective_bytes_of_spec` are the reference's.

Between the replicas of a serving cluster, each on a mesh of its own
(``launch.mesh.replica_meshes``), only host data moves, over the world's
gloo group (a replica mesh's ``host``): :class:`Fanout` broadcasts the
small integer arrays a replica's device returned (sampled tokens, EOS
flags) from its first rank to every rank, and :func:`send_tree` /
:func:`recv_tree` carry a migrating request's KV payload from the source
replica's first rank to each rank of the destination, through pinned
host memory.
"""
from __future__ import annotations

import functools
import json
import math

import numpy as np
import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place.  Over gloo a CUDA tensor
    goes the ring route (:func:`_ring_all_reduce`): gloo's own CUDA
    all-reduce took 6.4 times as long as the ring gather at 1 MB of bf16
    (PERF.md)."""
    if group is None:
        return x
    if _via_host(dist.get_backend(group), x):
        return x.copy_(_ring_all_reduce(x, group))
    dist.all_reduce(x, group=group)
    return x


def _ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce` as a ring gather (:func:`_ring_gather`) and a sum
    in group-rank order on every rank, so every rank gets the same bits:
    ``n - 1`` sends a rank, half those of a ring reduce-scatter and gather
    (each send waits for the card to drain), and on two ranks the same
    bytes."""
    return functools.reduce(torch.add, _ring_gather(x.contiguous(), group).unbind(0))


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
    if _via_host(dist.get_backend(group), x):
        return _ring_gather(x, group)
    out = x.new_empty((dist.get_world_size(group), *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    return torch.cat(gather_stack(x, group).unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its part
    along ``dim`` (the group's size divides it): a new tensor."""
    if group is None:
        return x
    if dist.get_backend(group) == "gloo":
        return _ring_reduce_scatter(x, group, dim)
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _ring_reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """:func:`reduce_scatter` as the ring algorithm of ``n - 1`` steps of
    :func:`shift`: at each step a rank passes its running sum of one part
    to the next rank and adds its own share of the part it receives, so
    each rank sends ``(n - 1) / n`` of ``x`` and sums on its own device."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    parts = x.chunk(n, dim)
    acc = parts[(r - 1) % n]
    for k in range(n - 1):
        acc = shift(acc.contiguous(), group, 1) + parts[(r - k - 2) % n]
    return acc.contiguous()


def _ring_gather(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_stack` as the ring algorithm of ``n - 1`` steps of
    :func:`shift`, each passing on the part received before."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = [x] * n
    cur = x
    for k in range(n - 1):
        cur = shift(cur, group, 1)
        out[(r - 1 - k) % n] = cur
    return torch.stack(out)


def broadcast_object(obj, src: int = 0):
    """``obj`` of the world's rank ``src`` on every rank (itself without a
    world)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ---------------------------------------------------------------------------
# differentiable forms
# ---------------------------------------------------------------------------
class CopyToGroup(torch.autograd.Function):
    """Identity forward, ``all_reduce`` backward: a replicated activation
    entering a split computation (each rank's gradient is a partial)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """``all_reduce`` forward, identity backward: partials summed into a
    replicated value whose gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromGroup(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward, reduce-scatter backward: a
    weight split over ``group`` (FSDP) made whole for a computation that
    each rank runs on its own rows."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


class ScatterToGroup(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, ``all_gather`` backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else CopyToGroup.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else ReduceFromGroup.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else GatherFromGroup.apply(x, group, dim)


def scatter_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else ScatterToGroup.apply(x, group, dim)


# ---------------------------------------------------------------------------
# send / receive between neighbours (pipeline stages)
# ---------------------------------------------------------------------------
def _via_host(backend: str, x: torch.Tensor) -> bool:
    """Whether ``backend`` lacks send / receive for ``x``'s device: gloo on
    a CUDA tensor."""
    return backend == "gloo" and x.is_cuda


def shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """What the rank ``offset`` before this one in ``group`` (cyclically)
    holds as ``x``: every rank sends its ``x`` to the rank ``offset`` after
    it (the reference's ``ppermute`` by ``offset``)."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    host = _via_host(dist.get_backend(group), x)
    if host:
        # pinned buffers (PyTorch caches them by size): the copies run at
        # the bus's rate, where pageable memory takes a staging copy more
        send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
        recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    else:
        send, recv = x.contiguous(), torch.empty_like(x, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, send, ranks[(r + offset) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(r - offset) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device, non_blocking=True) if host else recv


class Shift(torch.autograd.Function):
    """:func:`shift` forward, the shift back in the backward: the gradient
    of what a rank received goes to the rank that sent it."""

    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.offset), None, None


# ---------------------------------------------------------------------------
# the reference's helpers
# ---------------------------------------------------------------------------
def int8_psum(x_q: torch.Tensor, scale: torch.Tensor, group) -> torch.Tensor:
    """All-reduce an int8 payload (and its f32 scale) over ``group``: the
    dequantized f32 mean over the group, as the reference computes it
    (the int32 sum of the payloads, times the largest scale, over the
    group's size).  The payloads cross the wire as int8 (gathered) and are
    summed in int32 on each rank: the sum of int8 payloads overflows int8,
    and an integer sum is exact in any order."""
    n = 1 if group is None else dist.get_world_size(group)
    total = gather_stack(x_q, group).to(torch.int32).sum(0, dtype=torch.int32)
    s_max = all_reduce_max(scale.float().clone(), group)
    return total.float() * s_max / float(n)


def collective_bytes_of_spec(shape, dtype_bytes: int, n_shards: int, kind: str) -> float:
    """Analytic wire bytes per collective (ring algorithms)."""
    total = math.prod(shape) * dtype_bytes
    if kind == "all-reduce":
        return 2 * total * (n_shards - 1) / n_shards
    if kind in ("all-gather", "reduce-scatter"):
        return total * (n_shards - 1) / n_shards
    if kind == "all-to-all":
        return total * (n_shards - 1) / n_shards
    if kind == "collective-permute":
        return total
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# host data between the replicas of a cluster
# ---------------------------------------------------------------------------
class Fanout:
    """A replica's host arrays shared with every rank of the world: the
    replica's first rank (``src``, a world rank) broadcasts them over the
    world's gloo ``group``, every rank at the same point of the cluster's
    host schedule.  ``broadcasts`` counts the calls."""

    def __init__(self, src: int, group):
        self.src, self.group = src, group
        self.broadcasts = 0

    def share(self, arrays: list[np.ndarray] | None, shapes) -> list[np.ndarray]:
        """``arrays`` (integer arrays of ``shapes``) as ``src`` holds them,
        on every rank, as int64; ``arrays`` is read on ``src`` only (a rank
        outside the replica passes None)."""
        sizes = [math.prod(s) for s in shapes]
        if dist.get_rank() == self.src:
            flat = torch.from_numpy(np.concatenate(
                [np.asarray(a, np.int64).reshape(-1) for a in arrays]))
        else:
            flat = torch.empty(sum(sizes), dtype=torch.int64)
        dist.broadcast(flat, src=self.src, group=self.group)
        self.broadcasts += 1
        out = flat.numpy()
        return [p.reshape(s) for p, s in zip(np.split(out, np.cumsum(sizes)[:-1]), shapes)]


def send_tree(tree: dict[str, torch.Tensor], dst: int, group) -> None:
    """Send a dict of tensors (any keys, dtypes and device) to world rank
    ``dst`` over the gloo ``group``: the sizes of its header and body, then
    one pinned host buffer of the header (each leaf's key, dtype and shape,
    as JSON) and each leaf's bytes."""
    head = json.dumps([[key, str(t.dtype).removeprefix("torch."), list(t.shape)]
                       for key, t in tree.items()]).encode()
    parts = []
    for t in tree.values():
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        parts += [raw, raw.new_zeros(_aligned(raw.numel()) - raw.numel())]
    body = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
    off = _aligned(len(head))
    buf = torch.zeros(off + body.numel(), dtype=torch.uint8, pin_memory=body.is_cuda)
    buf[:len(head)] = torch.frombuffer(bytearray(head), dtype=torch.uint8)
    buf[off:].copy_(body)
    dist.send(torch.tensor([len(head), buf.numel()], dtype=torch.int64), dst, group=group)
    dist.send(buf, dst, group=group)


def recv_tree(src: int, group, pin: bool = False) -> dict[str, torch.Tensor]:
    """Receive :func:`send_tree`'s dict from world rank ``src``: CPU
    tensors, views of one buffer (pinned with ``pin``, for a non-blocking
    copy to a card)."""
    sizes = torch.zeros(2, dtype=torch.int64)
    dist.recv(sizes, src, group=group)
    n_head, n_buf = sizes.tolist()
    buf = torch.empty(n_buf, dtype=torch.uint8, pin_memory=pin)
    dist.recv(buf, src, group=group)
    out, off = {}, _aligned(n_head)
    for key, dtype, shape in json.loads(bytes(buf[:n_head].numpy())):
        dt = getattr(torch, dtype)
        n = math.prod(shape) * dt.itemsize
        out[key] = buf[off:off + n].view(dt).reshape(shape)
        off += _aligned(n)
    return out


def _aligned(n: int) -> int:
    """``n`` bytes padded to 8: every leaf of a tree's buffer starts
    aligned for its dtype."""
    return -(-n // 8) * 8
