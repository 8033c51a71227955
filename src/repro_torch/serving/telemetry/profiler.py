"""Sampled per-dispatch wall-clock profiler: the measured half of Fig 8.

Counterpart of ``repro.serving.telemetry.profiler``.  The step timeline
(``timeline.py``) charges every dispatch *analytic* FLOPs/bytes from the
roofline model; nothing there measures what the hardware achieved.
:class:`DispatchProfiler` closes that gap by timing a **sample** of
dispatches between two fences and joining the measured seconds with the
dispatch's analytic cost:

* ``measured_mfu``  = flops / (seconds * device peak FLOP/s)
* ``measured_mbu``  = bytes / (seconds * device peak HBM B/s)
* ``achieved_gbps`` = bytes / seconds / 1e9

The fence is ``torch.cuda.synchronize(device)`` on a CUDA engine (the
reference blocks on its arrays with ``jax.block_until_ready``); on the
CPU, where every op has finished when it returns, it does nothing.  A
failed synchronize raises.  The peaks default to ``H100-SXM``
(``core/oi.py``), the card the port runs on; an unknown device name
raises.

Sampling contract
-----------------
Fencing a dispatch drains the async dispatch-ahead pipeline (the *pre*
fence waits out all previously dispatched steps so queued work is not
billed to this one; the *post* fence waits for this dispatch alone), so
timing **every** step would serialize the engine back to sync mode.  The
profiler therefore fences only every ``sample_every``-th dispatch —
``sample_every=1`` times every dispatch — and the unsampled majority
keep full overlap.  The measured interval covers one step's host-side
composition plus its device execution.

Not counted as dispatches, so never sampled and not ticked: the
whole-prompt prefills of decode-only admission (as in the reference),
and, under CUDA graphs, the dispatch whose program warms up and is
captured in that call (``serving/programs.py``): its eager run plus the
capture take milliseconds to a second, which would be billed as one
step.  On the CPU nothing is captured, so the sampled dispatches are the
reference engine's.

The profiler never touches tokens, RNG, or scheduler state: greedy
outputs are identical with it enabled.  Engines default to
:data:`NULL_PROFILER`, whose hooks are no-ops and whose
``enabled = False`` lets the engine skip the per-dispatch bookkeeping
entirely — the same zero-cost contract as
:data:`~repro_torch.serving.telemetry.tracer.NULL_TRACER`.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.oi import DEVICES, Device

DEFAULT_DEVICE = "H100-SXM"


class NullDispatchProfiler:
    """The disabled profiler: every hook is a no-op and ``enabled`` is
    False so engines skip sampling decisions and record joins entirely."""

    enabled = False
    samples: tuple = ()

    def tick(self) -> bool:
        return False

    def begin(self, device) -> None:
        pass

    def end(self, device) -> None:
        pass

    def commit(self, record) -> None:
        pass


NULL_PROFILER = NullDispatchProfiler()


@dataclasses.dataclass
class ProfileSample:
    """One fenced dispatch: measured seconds joined with analytic cost."""

    replica: int
    step: int                   # engine-step id of the dispatch
    kind: str                   # decode | fused | solo | spec | ...
    bucket: int | None          # the chunk's bucket (None: no chunk)
    decode_batch: int
    seconds: float              # fence-to-fence wall clock
    flops: float                # analytic FLOPs (DispatchCostModel)
    bytes: float                # analytic HBM bytes
    oi: float                   # flops / bytes
    measured_mfu: float
    measured_mbu: float
    achieved_gbps: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fence(device) -> None:
    """Wait until ``device`` has run everything enqueued on it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DispatchProfiler:
    """Samples dispatch wall-clock between device fences and joins it
    with the step's analytic FLOPs/bytes — a live Fig 8."""

    enabled = True

    def __init__(self, sample_every: int = 8, device: str | Device = DEFAULT_DEVICE):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        if isinstance(device, str) and device not in DEVICES:
            raise ValueError(f"unknown profile device {device!r} "
                             f"(known: {', '.join(sorted(DEVICES))})")
        self.sample_every = sample_every
        self.device = DEVICES[device] if isinstance(device, str) else device
        self.samples: list[ProfileSample] = []
        self._n = 0             # dispatches seen (sampled or not)
        self._t0: float | None = None
        self._dt: float | None = None

    @property
    def sync(self) -> bool:
        """Sync mode: every dispatch is fenced and timed."""
        return self.sample_every == 1

    # ------------------------------------------------------------ sampling
    def tick(self) -> bool:
        """Count one dispatch; True when this one should be fenced."""
        self._n += 1
        return self._n % self.sample_every == 0

    def begin(self, device) -> None:
        """Pre-dispatch fence: wait out all previously dispatched device
        work so the sampled interval bills only the next dispatch."""
        _fence(device)
        self._t0 = time.perf_counter()

    def end(self, device) -> None:
        """Post-dispatch fence: wait for the sampled dispatch itself."""
        _fence(device)
        self._dt = time.perf_counter() - self._t0
        self._t0 = None

    def commit(self, record) -> None:
        """Join the fenced interval with the dispatch's StepRecord: append
        a :class:`ProfileSample` and annotate the record in place so the
        Perfetto exporter can emit measured counter tracks."""
        dt = self._dt
        self._dt = None
        if dt is None or record is None:
            return
        dt = max(dt, 1e-9)
        mfu = record.flops / (dt * self.device.flops)
        mbu = record.bytes / (dt * self.device.bw)
        gbps = record.bytes / dt / 1e9
        record.measured_s = dt
        record.measured_mfu = mfu
        record.measured_mbu = mbu
        record.achieved_gbps = gbps
        self.samples.append(ProfileSample(
            replica=record.replica, step=record.step, kind=record.kind,
            bucket=record.bucket, decode_batch=record.decode_batch,
            seconds=dt, flops=record.flops, bytes=record.bytes, oi=record.oi,
            measured_mfu=mfu, measured_mbu=mbu, achieved_gbps=gbps,
        ))

    # ----------------------------------------------------------- reporting
    def summary(self) -> dict[tuple, dict[str, float]]:
        """Aggregate per ``(kind, bucket, decode_batch)``: sample count,
        mean seconds, and mean measured MFU/MBU/bandwidth — the measured
        twin of the paper's Fig-8 rows."""
        groups: dict[tuple, list[ProfileSample]] = {}
        for s in self.samples:
            groups.setdefault((s.kind, s.bucket, s.decode_batch), []).append(s)
        out: dict[tuple, dict[str, float]] = {}
        for key in sorted(groups, key=lambda k: (k[0], k[1] or 0, k[2])):
            ss = groups[key]
            n = len(ss)
            out[key] = {
                "n": float(n),
                "seconds": sum(s.seconds for s in ss) / n,
                "oi": sum(s.oi for s in ss) / n,
                "measured_mfu": sum(s.measured_mfu for s in ss) / n,
                "measured_mbu": sum(s.measured_mbu for s in ss) / n,
                "achieved_gbps": sum(s.achieved_gbps for s in ss) / n,
            }
        return out

    def register(self, reg) -> None:
        """Publish the measured view into a :class:`MetricsRegistry`:
        overall gauges plus per-dispatch sample histograms."""
        reg.counter("profiled_dispatches").inc(len(self.samples))
        reg.gauge("profile_sample_every").set(self.sample_every)
        if not self.samples:
            return
        n = len(self.samples)
        reg.gauge("measured_mfu").set(
            sum(s.measured_mfu for s in self.samples) / n
        )
        reg.gauge("measured_mbu").set(
            sum(s.measured_mbu for s in self.samples) / n
        )
        reg.gauge("achieved_gbps").set(
            sum(s.achieved_gbps for s in self.samples) / n
        )
        reg.histogram("dispatch_seconds").extend(
            s.seconds for s in self.samples
        )

    def describe(self) -> str:
        """One-line measured summary for the terminal dashboard."""
        if not self.samples:
            return "measured: no samples yet"
        n = len(self.samples)
        mfu = sum(s.measured_mfu for s in self.samples) / n
        mbu = sum(s.measured_mbu for s in self.samples) / n
        bw = sum(s.achieved_gbps for s in self.samples) / n
        return (f"measured[{self.device.name}]: mfu={mfu:.4f} mbu={mbu:.4f} "
                f"bw={bw:.1f}GB/s (n={n}, every {self.sample_every})")


def make_profiler(sample_every: int,
                  device: str = DEFAULT_DEVICE) -> DispatchProfiler | NullDispatchProfiler:
    """CLI helper: ``sample_every <= 0`` means disabled (NULL profiler),
    ``1`` times every dispatch, ``N`` fences every Nth dispatch."""
    if sample_every <= 0:
        return NULL_PROFILER
    return DispatchProfiler(sample_every=sample_every, device=device)


__all__ = [
    "DEFAULT_DEVICE",
    "NULL_PROFILER",
    "DispatchProfiler",
    "NullDispatchProfiler",
    "ProfileSample",
    "make_profiler",
]
