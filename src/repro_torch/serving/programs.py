"""One program per dispatch kind: the port's counterpart of the JAX
engine's ``jax.jit`` calls.

The reference compiles each dispatch kind of its engine (decode, the
hybrid schedule's ``fused`` / ``solo`` / ``fused2`` / ``solo2``, the
speculative ``spec`` / ``spec_fused``, the draft's chunk prefill) into one
XLA program whose scalars (slot, lane, offset, valid length, last chunk)
are traced, so one compiled program serves every step of its kind.  A
:class:`Program` holds such a kind's body, a Python function of the
program's static input buffers that returns its outputs, and on a CUDA
device one CUDA graph of that body:

* the inputs live in one static int32 device buffer; a dispatch writes
  its values there with one pinned, non-blocking host-to-device copy, in
  stream order after the previous replay;
* the first call is the warm-up: it runs the body eagerly on a side
  stream (that call is the real dispatch; it sets up lazy state such as
  cuBLAS workspaces and the kernels' shared-memory attributes), then
  captures the body into a CUDA graph in the engine's memory pool, which
  all of an engine's kinds share (they replay one at a time on one
  stream, and each keeps its outputs alive);
* every later call replays the graph on the current stream and returns
  the capture's static outputs, which the next replay overwrites: the
  caller reads them, or enqueues their copy, before it calls again.

Streams and cuBLAS workspaces: PyTorch keeps one cuBLAS workspace (32
MiB on Hopper) per (handle, stream) for the life of the process, and a
new ``torch.cuda.Stream`` takes the next of its pool's 32 streams, so a
stream per engine or per capture ended up holding 33 workspaces, 1.1 GB.
Every program warms up and captures on the one :func:`side_stream` of its
device; :func:`release_workspaces` frees the cached workspaces once no
captured graph is alive (a graph keeps the address of the workspace its
capture used).

The kernels' launch counters count Python calls, which a replay does not
make: the launches a capture counted are taken off the counters, kept
with the graph and added back on every replay.  Generators the body
draws from are registered with the graph, so each replay draws fresh
numbers.  A capture that fails raises; nothing falls back to eager.  With
``graphs`` off (always on the CPU) the body runs eagerly through the same
buffers.
"""
from __future__ import annotations

import gc
import math
import time
import weakref
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import LaunchCounter, ops
from repro_torch.serving.paged import device as paged_dev

Outputs = tuple[torch.Tensor, ...]

_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
# programs whose graph has been captured (held weakly: a dead engine's
# programs leave the set with it)
_CAPTURED: weakref.WeakSet = weakref.WeakSet()


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's one side stream for warm-ups and captures, made at
    first use."""
    device = torch.device(device)
    if device.index is None:                    # "cuda" and "cuda:0" are one card
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def live_graphs() -> int:
    """Captured programs still alive, on any device."""
    return sum(p.graph is not None for p in _CAPTURED)


def release_workspaces() -> bool:
    """Free PyTorch's cached cuBLAS workspaces (they come back at the next
    product) if no captured graph is alive, and say whether it did.  A
    graph that is alive may replay into the workspace its capture used,
    so then nothing is freed."""
    if live_graphs() or not torch.cuda.is_available():
        return False
    torch._C._cuda_clearCublasWorkspaces()
    return True


class Program:
    """One dispatch kind: ``body(inputs) -> outputs`` over static inputs
    named and shaped by ``inputs`` (int32), run eagerly or, with
    ``graphs``, captured once and replayed.  ``pool`` is the graph memory
    pool (``torch.cuda.graph_pool_handle()``), ``generators`` those the
    body draws from.  The warm-up and the capture run on the device's
    :func:`side_stream`."""

    def __init__(self, name: str, body: Callable[[dict[str, torch.Tensor]], Outputs],
                 inputs: dict[str, tuple[int, ...]], device: torch.device, *,
                 graphs: bool = False, pool=None,
                 generators: Sequence[torch.Generator] = ()):
        if graphs and device.type != "cuda":
            raise ValueError(f"program {name}: CUDA graphs need a CUDA device, not {device}")
        self.name = name
        self.body = body
        self.device = device
        self.graphs = graphs
        self.pool = pool
        self.generators = tuple(generators)
        sizes = {k: math.prod(shape) for k, shape in inputs.items()}
        self._host = np.zeros(sum(sizes.values()), np.int32)
        self.args = torch.zeros(len(self._host), dtype=torch.int32, device=device)
        self.inputs: dict[str, torch.Tensor] = {}
        self._slices: dict[str, slice] = {}
        off = 0
        for k, shape in inputs.items():
            self._slices[k] = slice(off, off + sizes[k])
            self.inputs[k] = self.args[off:off + sizes[k]].view(shape)
            off += sizes[k]
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Outputs = ()
        self.launches: dict[str, LaunchCounter] = {}    # kernel launches per replay
        self.calls = 0
        self.replays = 0
        self.capture_s = 0.0

    def __call__(self, **values) -> Outputs:
        """Run one dispatch with the given input values (one per input
        name, array-likes of its shape)."""
        if self._slices:
            for k, sl in self._slices.items():
                self._host[sl] = np.asarray(values[k], np.int32).reshape(-1)
            self.args.copy_(paged_dev.host_copy(self._host, self.device), non_blocking=True)
        self.calls += 1
        if not self.graphs:
            return self.body(self.inputs)
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        ops.add_counts(self.launches)
        self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self) -> Outputs:
        main = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(self.inputs)        # this dispatch, eagerly: the warm-up
        main.wait_stream(side)
        for t in out:
            t.record_stream(main)
        snap = ops.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        # no cyclic collection inside the capture: one that freed another
        # graph there would invalidate this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                outputs = self.body(self.inputs)
        finally:
            if collecting:
                gc.enable()
            self.launches = ops.counts_since(snap)
            ops.restore_counts(snap)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs = graph, tuple(outputs)
        _CAPTURED.add(self)
        return out
