"""Terminal dashboard: one periodic snapshot line-block per interval.

``--dashboard N`` on the serve CLI prints this every N driver rounds —
the operator's live view of the same state the trace and metrics record:
the engine's queue depth, active slots, dispatch-ahead pipeline depth,
block-pool / host-tier utilization and generated-token counter, plus the
SLO attainment line (:meth:`SLOMonitor.describe`) and the measured
MFU/MBU line (:meth:`DispatchProfiler.describe`) when those are on.

The engine line of ``repro.serving.telemetry.dashboard``; the cluster's
header and replica rows come with the cluster (ROADMAP.md queue 1 item
5).  The port's engines have no disaggregation role: every engine prints
as the reference's ``mixed`` role, ``[M]``.

Pure string rendering over host-side bookkeeping — no device reads, no
extra work recorded into the run being observed.
"""
from __future__ import annotations


def _engine_line(eng) -> str:
    active = sum(s is not None for s in eng.slots)
    line = (f"  r{eng.replica}[M] "
            f"queue={len(eng.sched)} active={active}/{len(eng.slots)} "
            f"depth={len(eng._pending)} gen={eng.stats.generated}")
    if eng.cache_kind == "paged":
        line += f" pool={eng.pool.utilization:.2f}"
        if eng.host_blocks:
            line += f" host={eng.pool.host_utilization:.2f}"
    return line


def render_dashboard(eng, round_no: int, slo=None, profiler=None) -> str:
    """Render one snapshot of an Engine."""
    lines = [f"[round {round_no}]", _engine_line(eng)]
    if slo is not None:
        lines.append("  " + slo.describe())
    if profiler is not None and getattr(profiler, "enabled", False):
        lines.append("  " + profiler.describe())
    return "\n".join(lines)


__all__ = ["render_dashboard"]
