"""Serving telemetry: request-span tracing, step timelines, metrics.

Counterpart of ``repro.serving.telemetry``, with the same exports but
``cluster_registry`` (it comes with the cluster, ROADMAP.md queue 1
item 5):

* :class:`Tracer` / :data:`NULL_TRACER` — one span tree per request on
  the engine-step clock (``tracer.py``);
* :class:`StepRecord` / :class:`DispatchCostModel` — per-dispatch
  composition + analytic FLOPs/bytes/OI (``timeline.py``);
* :class:`DispatchProfiler` / :data:`NULL_PROFILER` — sampled fenced
  wall-clock per dispatch, joined with the analytic costs into measured
  MFU/MBU/bandwidth (``profiler.py``);
* :class:`SLOMonitor` — TTFT/TPOT targets, sliding-window attainment,
  goodput (``slo.py``);
* :class:`MetricsRegistry` + :func:`engine_registry` — the single
  reporting view over engine stats with exact percentiles
  (``metrics.py``);
* Perfetto/Chrome-trace and metrics JSON exporters (``export.py``);
* :func:`render_dashboard` — periodic terminal snapshot
  (``dashboard.py``).

Telemetry is zero-cost when disabled (engines default to
:data:`NULL_TRACER` and :data:`NULL_PROFILER`) and — except for the
profiler's explicitly sampled fences — records only at host-side
dispatch/observe boundaries, never inside a captured program.  On the
CPU a traced run of the port gives the reference engine's trace, step
timeline and metrics snapshot.
"""
from repro_torch.serving.telemetry.dashboard import render_dashboard
from repro_torch.serving.telemetry.export import (
    build_request_trees,
    to_chrome_trace,
    validate_trace,
    write_metrics,
    write_trace,
)
from repro_torch.serving.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    engine_registry,
    percentile,
)
from repro_torch.serving.telemetry.profiler import (
    NULL_PROFILER,
    DispatchProfiler,
    NullDispatchProfiler,
    ProfileSample,
    make_profiler,
)
from repro_torch.serving.telemetry.slo import SLOMonitor
from repro_torch.serving.telemetry.timeline import DispatchCostModel, StepRecord
from repro_torch.serving.telemetry.tracer import (
    NULL_TRACER,
    TRACK_QUEUE,
    TRACK_ROUTER,
    TRACK_STEPS,
    Event,
    NullTracer,
    Span,
    Tracer,
)

__all__ = [
    "NULL_PROFILER",
    "NULL_TRACER",
    "TRACK_QUEUE",
    "TRACK_ROUTER",
    "TRACK_STEPS",
    "Counter",
    "DispatchCostModel",
    "DispatchProfiler",
    "Event",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullDispatchProfiler",
    "NullTracer",
    "ProfileSample",
    "SLOMonitor",
    "Span",
    "StepRecord",
    "Tracer",
    "build_request_trees",
    "engine_registry",
    "make_profiler",
    "percentile",
    "render_dashboard",
    "to_chrome_trace",
    "validate_trace",
    "write_metrics",
    "write_trace",
]
