"""Meshes of ranks over ``torch.distributed``: one process per rank.

Counterpart of ``repro.launch.mesh`` (``make_host_mesh``, ``mesh_axes``,
``replica_meshes``).  The reference lays JAX devices out on named axes
(``pod``, ``data``, ``model``); the port lays the ranks of a
``torch.distributed`` world out the same way, row-major with the last
axis fastest, and makes one process group per set of axes
(:meth:`DeviceMesh.group`), on which ``distributed.collectives`` runs.

The world comes from the launcher: ``torchrun`` sets ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK`` and :func:`init_world` joins it over
``env://``; a caller (a test) may instead initialise the default group
itself.  A single process with no group is a mesh of one rank,
``{"data": 1, "model": 1}``, and initialises nothing.  The backend is
chosen from the layout: ``nccl`` when every rank of a host has a card of
its own, ``gloo`` on the CPU or when ranks share a card (NCCL refuses two
ranks on one device).  ``make_production_mesh`` (the reference's
512-chip dry-run mesh) comes with the dry run.

A serving cluster gives each replica a mesh of its own slice of the
world (:func:`replica_meshes`): every rank builds every replica's mesh,
:attr:`DeviceMesh.ranks` names the replica's ranks (``ranks[0]`` its
first) and :attr:`DeviceMesh.coords` is None where the rank is not a
member.  What the replicas share on the host (their fetched tokens, the
KV payloads that migrate between them) moves over each mesh's
:attr:`DeviceMesh.host`, a gloo group of the whole world.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist

# how long a rank waits for the others in a rendezvous or a collective
TIMEOUT = datetime.timedelta(seconds=300)


def local_world() -> tuple[int, int]:
    """``(LOCAL_RANK, LOCAL_WORLD_SIZE)`` of this process (torchrun's;
    ``(0, 1)`` outside it)."""
    return (int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))))


def backend_for(device: torch.device) -> str:
    """``nccl`` when each rank of this host has a card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world()[1] else "gloo"


def rank_device(device: str | torch.device | None) -> torch.device:
    """This rank's device: for CUDA, card ``LOCAL_RANK`` modulo the cards
    visible (every rank on card 0 when there is one)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_world()[0] % torch.cuda.device_count())
    return dev


def init_world(device: str | torch.device | None = None) -> None:
    """Join the launcher's world (``env://``) when ``WORLD_SIZE`` > 1 and
    no group is up yet, on the backend of this rank's device."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://", timeout=TIMEOUT)


def host_group():
    """A gloo group of the whole world, for host tensors (CPU tensors only
    move over gloo): the default group when it is gloo, else a new one,
    which every rank makes at the same point (group creation is
    collective).  None without a world."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default group (``(0, 1)`` without)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DeviceMesh:
    """``ranks`` of the world laid out row-major on named axes.  Every rank
    of the world constructs every mesh (group creation is collective);
    ``coords`` is None on a rank outside it.  ``host`` is the world's gloo
    group over which a replica's mesh shares host data with the ranks
    outside it (:func:`replica_meshes` sets it)."""

    host = None

    def __init__(self, shape: dict[str, int], ranks: list[int] | None = None):
        self.axis_names = tuple(shape)
        self.shape = tuple(shape.values())
        size = math.prod(self.shape)
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        if len(self.ranks) != size:
            raise ValueError(f"a mesh of {dict(shape)} needs {size} ranks, got {self.ranks}")
        me = world()[0]
        self.coords = (None if me not in self.ranks else
                       tuple(int(c) for c in _unravel(self.ranks.index(me), self.shape)))
        self._groups: dict[tuple[str, ...], object] = {}
        names = [a for a, n in shape.items() if n > 1]
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                self._make_groups(axes)

    def _make_groups(self, axes: tuple[str, ...]) -> None:
        """One group per value of the other axes' coordinates (every world
        rank calls ``new_group`` for each, in the same order); keep ours."""
        dims = [self.axis_names.index(a) for a in axes]
        others = [range(n) if i not in dims else [None] for i, n in enumerate(self.shape)]
        for fixed in itertools.product(*others):
            members = []
            for inner in itertools.product(*(range(self.shape[d]) for d in dims)):
                coord = list(fixed)
                for d, c in zip(dims, inner):
                    coord[d] = c
                members.append(self.ranks[_ravel(coord, self.shape)])
            group = dist.new_group(sorted(members))
            if self.coords is not None and world()[0] in members:
                self._groups[axes] = group

    def _live(self, axes) -> tuple[str, ...]:
        """``axes`` less those of size 1, in mesh order (a spec lists its
        axes in mesh order; any other order is refused)."""
        live = tuple(a for a in axes if self.size_of(a) > 1)
        if list(live) != sorted(live, key=self.axis_names.index):
            raise ValueError(f"axes {axes} are not in the mesh's order {self.axis_names}")
        return live

    def size_of(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def size(self, axes) -> int:
        """Ranks in one group of ``axes``."""
        return math.prod(self.size_of(a) for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``: its rank in their group."""
        idx = 0
        for a in self._live(axes):
            idx = idx * self.size_of(a) + self.coords[self.axis_names.index(a)]
        return idx

    def group(self, axes):
        """The process group of this rank's fellows along ``axes`` (None
        for a group of one)."""
        live = self._live(axes)
        return self._groups[live] if live else None

    def __repr__(self) -> str:
        return f"DeviceMesh({dict(zip(self.axis_names, self.shape))}, ranks={self.ranks})"


def _unravel(i: int, shape) -> list[int]:
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return out[::-1]


def _ravel(coord, shape) -> int:
    i = 0
    for c, n in zip(coord, shape):
        i = i * n + c
    return i


def make_host_mesh(model_parallel: int = 1, device: str | torch.device | None = None
                   ) -> DeviceMesh:
    """The world as a ``(data, model)`` mesh: ``model_parallel`` ranks on
    ``model`` when it divides the world, else 1.  Joins the launcher's
    world first if there is one (:func:`init_world` on ``device``)."""
    init_world(device)
    n = world()[1]
    mp = model_parallel if n % model_parallel == 0 else 1
    return DeviceMesh({"data": n // mp, "model": mp})


def mesh_axes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def replica_meshes(n_replicas: int, model_parallel: int = 1,
                   device: str | torch.device | None = None) -> list[DeviceMesh]:
    """One ``(data, model)`` mesh per serving replica, on disjoint
    contiguous slices of the world's ranks; when the world cannot be split
    so (fewer ranks than replicas, or a count that does not divide), every
    replica shares the one host mesh, as in the reference.  Split meshes
    share the world's :func:`host_group` as their ``host``, over which the
    replicas share their host arrays."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    init_world(device)
    n = world()[1]
    if n % n_replicas != 0 or n < n_replicas:
        return [make_host_mesh(model_parallel)] * n_replicas
    per = n // n_replicas
    mp = model_parallel if per % model_parallel == 0 else 1
    meshes = [DeviceMesh({"data": per // mp, "model": mp}, range(i * per, (i + 1) * per))
              for i in range(n_replicas)]
    host = host_group()
    for m in meshes:
        m.host = host
    return meshes


def split(meshes: list[DeviceMesh]) -> bool:
    """Whether :func:`replica_meshes` gave the replicas meshes of their
    own (else they share the one host mesh)."""
    return len({id(m) for m in meshes}) > 1
