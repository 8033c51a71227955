"""Fault tolerance: straggler detection + elastic rescale planning.

At thousand-node scale the framework must (a) notice slow/failed workers,
(b) restart from the last step-atomic checkpoint on a smaller/larger
mesh, and (c) keep the global data order.  The pieces here are pure logic
(unit-tested on CPU); the launch scripts wire them to real processes.

A copy of ``repro.distributed.fault_tolerance``: ``StragglerMonitor``,
``Heartbeat``, ``MeshPlan``, ``plan_rescale`` and ``Supervisor``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


# ---------------------------------------------------------------------------
# straggler detection (feeds the paper's §IV-C balancer re-tuning as well)
# ---------------------------------------------------------------------------
class StragglerMonitor:
    """Per-worker step-time tracker with robust outlier detection.

    A worker is a straggler when its rolling-median step time exceeds
    ``threshold`` x the fleet median for ``patience`` consecutive windows.
    """

    def __init__(self, n_workers: int, window: int = 16, threshold: float = 1.5,
                 patience: int = 3):
        self.times: list[deque] = [deque(maxlen=window) for _ in range(n_workers)]
        self.threshold = threshold
        self.patience = patience
        self.strikes = [0] * n_workers

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, worker: int, step_time: float):
        self.times[worker].append(step_time)

    def fleet_median(self) -> float:
        per = [self._median(t) for t in self.times if t]
        return self._median(per) if per else 0.0

    def check(self) -> list[int]:
        """Returns workers currently flagged as stragglers."""
        fleet = self.fleet_median()
        flagged = []
        for w, t in enumerate(self.times):
            if not t or fleet == 0.0:
                continue
            if self._median(t) > self.threshold * fleet:
                self.strikes[w] += 1
            else:
                self.strikes[w] = 0
            if self.strikes[w] >= self.patience:
                flagged.append(w)
        return flagged


class Heartbeat:
    """Deadline-based liveness: workers report; ``dead()`` lists misses."""

    def __init__(self, n_workers: int, timeout: float):
        self.timeout = timeout
        self.last = [time.monotonic()] * n_workers

    def beat(self, worker: int, now: float | None = None):
        self.last[worker] = time.monotonic() if now is None else now

    def dead(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [w for w, t in enumerate(self.last) if now - t > self.timeout]


# ---------------------------------------------------------------------------
# elastic rescale planning
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    global_batch: int
    grad_accum: int


def plan_rescale(
    n_devices: int,
    model_parallel: int,
    global_batch: int,
    multi_pod_size: int | None = None,
) -> MeshPlan:
    """Re-plan the mesh after losing/gaining devices.

    Keeps the `model` axis fixed (weights layout unchanged -> cheap
    restore) and shrinks/grows `data`.  The global batch is preserved via
    grad accumulation when per-step capacity drops; this keeps training
    curves comparable across rescales.
    """
    if n_devices % model_parallel:
        # drop remainder devices (spares)
        n_devices -= n_devices % model_parallel
    if n_devices <= 0:
        raise ValueError("no usable devices for the requested model parallelism")
    data = n_devices // model_parallel
    if multi_pod_size and n_devices > multi_pod_size:
        pods = n_devices // multi_pod_size
        data = multi_pod_size // model_parallel
        shape = (pods, data, model_parallel)
        axes = ("pod", "data", "model")
        capacity = pods * data
    else:
        shape = (data, model_parallel)
        axes = ("data", "model")
        capacity = data
    # keep the global batch constant: find the smallest grad-accum factor
    # such that the per-step microbatch splits evenly over the data shards
    accum = 1
    while accum <= global_batch:
        micro = global_batch // accum
        if global_batch % accum == 0 and micro % capacity == 0:
            break
        accum += 1
    else:
        raise ValueError("cannot split batch across devices")
    return MeshPlan(shape, axes, global_batch, accum)


# ---------------------------------------------------------------------------
# supervised training loop (restart-on-failure)
# ---------------------------------------------------------------------------
class Supervisor:
    """Runs ``run_fn(start_step) -> last_step`` with restart-from-checkpoint
    on exceptions, up to ``max_restarts``.  ``run_fn`` raising simulates a
    node failure in tests; in production it's the train loop."""

    def __init__(self, run_fn: Callable[[int], int], latest_step: Callable[[], int | None],
                 max_restarts: int = 3):
        self.run_fn = run_fn
        self.latest_step = latest_step
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, start_step: int = 0) -> int:
        step = start_step
        while True:
            try:
                return self.run_fn(step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                last = self.latest_step()
                step = 0 if last is None else last
