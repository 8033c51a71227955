"""Terminal dashboard: one periodic snapshot line-block per interval.

``--dashboard N`` on the serve CLI prints this every N driver rounds —
the operator's live view of the same state the trace and metrics record:
per-replica queue depth, active slots, dispatch-ahead pipeline depth,
block-pool / host-tier utilization, generated-token counters, plus the
SLO attainment line (:meth:`SLOMonitor.describe`) and the measured
MFU/MBU line (:meth:`DispatchProfiler.describe`) when those are on.

A copy of ``repro.serving.telemetry.dashboard``: a cluster prints its
global queue in the header and one row per replica, ``r{replica}[{role}]``.

Pure string rendering over host-side bookkeeping — no device reads, no
extra work recorded into the run being observed.
"""
from __future__ import annotations


def _engine_line(eng) -> str:
    active = sum(s is not None for s in eng.slots)
    line = (f"  r{eng.replica}[{eng.role[0].upper()}] "
            f"queue={len(eng.sched)} active={active}/{len(eng.slots)} "
            f"depth={len(eng._pending)} gen={eng.stats.generated}")
    if eng.cache_kind == "paged":
        line += f" pool={eng.pool.utilization:.2f}"
        if eng.host_blocks:
            line += f" host={eng.pool.host_utilization:.2f}"
    return line


def render_dashboard(serv, round_no: int, slo=None, profiler=None) -> str:
    """Render one snapshot of an Engine or Cluster front-end."""
    engines = getattr(serv, "engines", None) or [serv]
    queue = getattr(serv, "queue", None)
    head = f"[round {round_no}]"
    if queue is not None:
        head += f" global_queue={len(queue)}"
    lines = [head]
    lines.extend(_engine_line(e) for e in engines)
    if slo is not None:
        lines.append("  " + slo.describe())
    if profiler is not None and getattr(profiler, "enabled", False):
        lines.append("  " + profiler.describe())
    return "\n".join(lines)


__all__ = ["render_dashboard"]
