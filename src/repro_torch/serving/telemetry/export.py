"""Exporters: Perfetto/Chrome-trace JSON, metrics dumps, span-tree views.

A copy of ``repro.serving.telemetry.export`` (pure Python): the same
records give the same JSON in both packages.

The trace format is the Chrome Trace Event JSON flavor Perfetto loads
directly (``ui.perfetto.dev`` -> Open trace file):

* one **process row per replica** (pid = replica index) with one thread
  row per engine slot, plus reserved rows for the admission queue and
  the per-dispatch step timeline;
* request lifecycle spans are complete events (``ph: "X"``), lifecycle
  markers are instant events (``ph: "i"``), and per-dispatch
  composition (operational intensity, budget fill, pool utilization,
  pipeline depth) is emitted both as args on the step-timeline spans and
  as counter tracks (``ph: "C"``) so Perfetto draws them as graphs;
* routing decisions live on a synthetic ``cluster`` process row.

Positions come from the deterministic engine-step clock: one engine step
renders as :data:`TICK_US` microseconds (1 ms), so traces from the same
workload diff cleanly run-to-run.  Wall-clock stamps, when the tracer
recorded them (``Tracer(wall=True)``), ride along in each event's args —
annotations, not positions, because the async engine records completions
at observe time, where wall timestamps would misplace spans that
actually overlapped on device.

:func:`validate_trace` is the small schema the tests and the GPU smoke
run (``chip_smoke.py``) assert against; :func:`build_request_trees` folds the
flat span/event lists back into one tree per request for structural
checks.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

from repro_torch.serving.telemetry.tracer import (
    TRACK_QUEUE,
    TRACK_ROUTER,
    TRACK_STEPS,
    Event,
    Span,
    Tracer,
)

TICK_US = 1000          # one engine step = 1000 us = 1 ms in the trace
CLUSTER_PID = 10_000    # synthetic process row for router decisions

_PH_ALLOWED = {"X", "i", "C", "M"}


# ------------------------------------------------------------- chrome trace
def _meta(pid: int, tid: int | None, name: str) -> dict:
    ev: dict[str, Any] = {
        "name": "process_name" if tid is None else "thread_name",
        "ph": "M", "pid": pid, "tid": 0 if tid is None else tid, "ts": 0,
        "args": {"name": name},
    }
    return ev


def _span_event(s: Span) -> dict:
    end = s.end if s.end is not None else s.start
    args: dict[str, Any] = {"uid": s.uid, "start_step": s.start,
                            "end_step": end, **s.attrs}
    if s.t_start is not None:
        args["wall_start"] = s.t_start
    if s.t_end is not None:
        args["wall_end"] = s.t_end
    return {
        "name": f"{s.name} u{s.uid}" if s.uid >= 0 else s.name,
        "cat": "request", "ph": "X", "pid": s.replica, "tid": s.track,
        "ts": s.start * TICK_US, "dur": max(end - s.start, 0) * TICK_US,
        "args": args,
    }


def _instant_event(e: Event) -> dict:
    pid = CLUSTER_PID if e.replica < 0 else e.replica
    args: dict[str, Any] = {"uid": e.uid, "step": e.step, **e.attrs}
    if e.t is not None:
        args["wall"] = e.t
    return {
        "name": e.name, "cat": "lifecycle", "ph": "i", "s": "t",
        "pid": pid, "tid": e.track, "ts": e.step * TICK_US, "args": args,
    }


def to_chrome_trace(tracer: Tracer) -> dict:
    """Render one tracer's records as a Perfetto-loadable trace dict."""
    events: list[dict] = []
    replicas = tracer.replicas()
    slot_tracks: dict[int, set[int]] = {r: set() for r in replicas}
    for s in tracer.spans:
        if 0 <= s.track < TRACK_QUEUE:
            slot_tracks.setdefault(s.replica, set()).add(s.track)
    for r in sorted(slot_tracks):
        events.append(_meta(r, None, f"replica {r}"))
        for t in sorted(slot_tracks[r]):
            events.append(_meta(r, t, f"slot {t}"))
        events.append(_meta(r, TRACK_QUEUE, "queue"))
        events.append(_meta(r, TRACK_STEPS, "steps"))

    for s in tracer.spans:
        events.append(_span_event(s))
    has_router = False
    for e in tracer.events:
        if e.replica < 0:
            has_router = True
        events.append(_instant_event(e))
        if e.name == "spec_verify":
            # acceptance as a counter track: Perfetto graphs accepted
            # draft tokens per speculative window next to the step rows
            events.append({
                "name": "accepted_per_step", "ph": "C", "pid": e.replica,
                "tid": 0, "ts": e.step * TICK_US,
                "args": {"accepted_per_step": e.attrs.get("accepted", 0)},
            })
    if has_router:
        events.append(_meta(CLUSTER_PID, None, "cluster"))
        events.append(_meta(CLUSTER_PID, TRACK_ROUTER, "router"))

    for rec in tracer.steps:
        ts = (rec.step - 1) * TICK_US       # dispatch rec.step spans (step-1, step]
        events.append({
            "name": rec.kind, "cat": "dispatch", "ph": "X",
            "pid": rec.replica, "tid": TRACK_STEPS, "ts": ts, "dur": TICK_US,
            "args": rec.as_dict(),
        })
        counters = {"oi": rec.oi, "budget_fill": rec.fill,
                    "pipeline_depth": rec.pipeline_depth}
        if rec.pool_util is not None:
            counters["pool_util"] = rec.pool_util
        if rec.host_util is not None:
            counters["host_util"] = rec.host_util
        if rec.measured_s is not None:
            # sampled-profiler join: the measured twin of the analytic
            # oi track, graphed by Perfetto as the live Fig-8 view
            counters["measured_mfu"] = rec.measured_mfu
            counters["measured_mbu"] = rec.measured_mbu
            counters["achieved_gbps"] = rec.achieved_gbps
        for cname, val in counters.items():
            events.append({
                "name": cname, "ph": "C", "pid": rec.replica, "tid": 0,
                "ts": ts, "args": {cname: val},
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "engine_steps", "tick_us": TICK_US},
    }


def write_trace(tracer: Tracer, path: str | Path) -> Path:
    """Validate and write the Chrome/Perfetto trace JSON."""
    obj = to_chrome_trace(tracer)
    problems = validate_trace(obj)
    if problems:
        raise ValueError(f"invalid trace: {problems[:5]}")
    path = Path(path)
    path.write_text(json.dumps(obj, indent=1) + "\n")
    return path


def write_metrics(registry, path: str | Path, extra: dict | None = None) -> Path:
    """Flat JSON dump of a :class:`MetricsRegistry` snapshot."""
    payload = dict(registry.snapshot())
    if extra:
        payload.update(extra)
    path = Path(path)
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


# --------------------------------------------------------------- validation
def validate_trace(obj) -> list[str]:
    """Schema check for the exported trace; returns problem strings
    (empty = valid).  Intentionally small — enough for tests and the
    smoke run to reject a malformed export, not a full Perfetto validator."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return ["top level is not an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PH_ALLOWED:
            problems.append(f"{where}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                problems.append(f"{where}: {field} not an int")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
        if ph in ("C", "M") and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: {ph} event needs args")
        if len(problems) >= 20:
            problems.append("... (truncated)")
            break
    return problems


# ---------------------------------------------------------------- span trees
@dataclasses.dataclass
class RequestTree:
    """One request's lifecycle, folded back into a tree: the synthesized
    root covers submit -> finish; children are the flat spans in step
    order; events are the instant markers."""

    replica: int
    uid: int
    start: int
    end: int | None
    spans: list[Span]
    events: list[Event]
    finished: bool

    def child(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def marks(self, name: str) -> list[Event]:
        return [e for e in self.events if e.name == name]

    def well_formed(self) -> list[str]:
        """Structural invariants every complete request tree must hold;
        returns problem strings (empty = well-formed)."""
        p: list[str] = []
        uid = f"u{self.uid}@r{self.replica}"
        queued = self.child("queued")
        chunks = self.child("prefill_chunk")
        decodes = self.child("decode")
        # A request migrated onto this replica (disaggregated serving)
        # was queued, chunked, admitted and produced its first token on
        # the *source* replica — its history here starts mid-decode.
        migrated_in = bool(self.marks("kv_migrate_in"))
        if not queued and not migrated_in:
            p.append(f"{uid}: no queued span")
        if not chunks and not migrated_in:
            p.append(f"{uid}: no prefill_chunk span")
        for s in self.spans:
            if s.closed and s.end < s.start:
                p.append(f"{uid}: span {s.name} ends before it starts")
        if self.finished:
            for s in self.spans:
                if not s.closed:
                    p.append(f"{uid}: finished request left {s.name} open")
            if not decodes:
                p.append(f"{uid}: finished request has no decode span")
            if not self.marks("finish"):
                p.append(f"{uid}: finished request has no finish event")
        # chunks advance monotonically through the (re-folded) prompt and
        # never overlap in positions within one admission
        pos = -1
        for c in chunks:
            if c.attrs.get("requeued"):
                continue
            start = c.attrs["pos"]
            if c.attrs["last"]:
                pos = -1            # next admission (refold) restarts
                continue
            if start < pos:
                p.append(f"{uid}: chunk positions regressed at {start}")
            pos = start
        admits = self.marks("admitted")
        if not admits and not migrated_in:
            p.append(f"{uid}: no admitted event")
        first = self.marks("first_token")
        if self.finished and not first and not migrated_in:
            p.append(f"{uid}: finished request has no first_token event")
        if first and admits and first[0].step < admits[0].step:
            p.append(f"{uid}: first_token before admission")
        # preemption bookkeeping: every preempted event pairs with a
        # refolded re-admission (or the run ended mid-queue)
        n_pre = len(self.marks("preempted"))
        n_refold = len(self.marks("refolded"))
        if self.finished and n_refold < n_pre:
            p.append(f"{uid}: {n_pre} preemptions but {n_refold} refolds")
        return p


def build_request_trees(tracer: Tracer) -> dict[tuple[int, int], RequestTree]:
    """Fold the tracer's flat records into one tree per (replica, uid)."""
    spans: dict[tuple[int, int], list[Span]] = {}
    events: dict[tuple[int, int], list[Event]] = {}
    for s in tracer.spans:
        spans.setdefault((s.replica, s.uid), []).append(s)
    for e in tracer.events:
        if e.replica < 0:
            continue
        events.setdefault((e.replica, e.uid), []).append(e)
    trees: dict[tuple[int, int], RequestTree] = {}
    for key, st in tracer.requests.items():
        ss = sorted(spans.get(key, []), key=lambda s: (s.start, s.track))
        es = sorted(events.get(key, []), key=lambda e: e.step)
        ends = [s.end for s in ss if s.end is not None]
        trees[key] = RequestTree(
            replica=key[0], uid=key[1], start=st.submit_step,
            end=max(ends) if ends else None, spans=ss, events=es,
            finished=st.finished,
        )
    return trees
