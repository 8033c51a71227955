"""Request-span tracing on the engine-step clock.

A copy of ``repro.serving.telemetry.tracer`` (pure Python), the cluster
hooks included; the port keeps its own so that it imports nothing of
``repro``.

The paper's argument is an accounting argument — co-processing wins only
if you can see where each step's time and bytes go — so the tracer
records *everything the engine already knows at its host-side dispatch
and observe boundaries* and nothing more: no timers inside a captured
program, no device syncs, no extra transfers.  Every record is stamped on
the deterministic ``EngineStats.engine_steps`` clock (the same clock TTFT
and tokens/step are measured on), with optional wall-clock timestamps
(``Tracer(wall=True)``) riding along as annotations.

One request produces one span tree::

    request (synthesized at export)
    ├── queued          submit -> admitted          (re-opens on preemption)
    ├── prefill_chunk   one per executed chunk      (whole prefill = 1 span)
    ├── ...             (hybrid: xN, boundary-packed chunks included)
    └── decode          first_token -> finish       (ends early on preempt)

plus instant events: ``admitted``, ``refolded`` (re-admission after a
preemption, generated tokens folded into the prefill), ``first_token``,
``preempted``, ``boundary_packed``, ``finish``, ``slo_breach`` (a
declared TTFT/TPOT target missed — ``Tracer(slo=monitor)`` forwards
first-token/finish observations to an
:class:`~repro_torch.serving.telemetry.slo.SLOMonitor`), and cluster-level
``route`` events (policy, chosen replica, spill).

Async dispatch-ahead engines close spans at *observe* time, one step
after the dispatch that produced the tokens.  Observe-time closes
therefore carry two wall stamps when ``wall=True``: the close's own
``t_end`` and a ``wall_dispatch`` attr looked up from the step's
dispatch record — viewers can reconstruct the true device overlap from
the pair.

Tracks: spans carry a ``(replica, track)`` address — ``track`` is the
engine slot the work ran on, or one of the reserved tracks
(:data:`TRACK_QUEUE` for pre-admission waits, :data:`TRACK_STEPS` for
the per-dispatch timeline, :data:`TRACK_ROUTER` on the cluster row for
routing decisions).  ``repro_torch.serving.telemetry.export`` turns these into
one Perfetto/Chrome-trace track per replica slot.

Disaggregated serving splits one request's history across replicas:
``on_migrate`` closes the source replica's spans and drops paired
``kv_migrate`` / ``kv_migrate_in`` instant marks (``on_refold_move``
likewise for re-placed preemptees), so a migrated request renders as
two half-trees joined by the marks — trace validation treats the marks
as the join key.

Zero-cost when disabled: engines default to :data:`NULL_TRACER`, whose
hooks are no-ops and whose ``enabled = False`` lets the engine skip even
building the per-dispatch :class:`~repro_torch.serving.telemetry.timeline.StepRecord`.
Nothing here ever runs inside a captured program.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

# reserved track ids (engine slots occupy 0..n_slots-1)
TRACK_QUEUE = 1000
TRACK_STEPS = 1001
TRACK_ROUTER = 1002


@dataclasses.dataclass
class Span:
    """A closed or still-open interval on one (replica, track) row."""

    replica: int
    track: int
    uid: int
    name: str
    start: int                  # engine-step clock
    end: int | None = None
    t_start: float | None = None    # wall clock (perf_counter), optional
    t_end: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.end is not None


@dataclasses.dataclass
class Event:
    """An instant marker on one (replica, track) row."""

    replica: int
    track: int
    uid: int
    name: str
    step: int
    t: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _RequestState:
    """Per-request open-span bookkeeping (host-side only)."""

    uid: int
    replica: int
    submit_step: int
    prompt_len: int
    queued: Span | None = None
    decode: Span | None = None
    finished: bool = False
    # request arrived by KV migration: its queued/prefill history lives
    # on the source replica's state (well-formedness checks adapt)
    migrated_in: bool = False


class NullTracer:
    """The disabled tracer: every hook is a no-op, ``enabled`` is False
    so engines skip building records entirely.  ``bind`` and friends
    return ``self`` so one singleton serves every call site."""

    enabled = False
    round = 0

    def on_submit(self, replica, req, step):
        pass

    def on_admit(self, replica, req, step, slot, n_tokens, refold=False):
        pass

    def on_chunk(self, replica, req, slot, start_step, end_step, pos,
                 n_valid, bucket, last):
        pass

    def on_first_token(self, replica, req, step, slot, first=True):
        pass

    def on_finish(self, replica, req, step, slot):
        pass

    def on_preempt(self, replica, req, step, slot):
        pass

    def on_boundary_pack(self, replica, req, step, slot):
        pass

    def on_spill(self, replica, step, dev_block, host_block):
        pass

    def on_rehydrate(self, replica, step, host_block, dev_block):
        pass

    def on_spec_propose(self, replica, step, depth, batch):
        pass

    def on_spec_verify(self, replica, step, accepted, batch):
        pass

    def on_step(self, record):
        pass

    def on_route(self, uid, replica, policy, rank_pos, hit_tokens, probed):
        pass

    def on_migrate(self, req, src_replica, src_step, src_slot,
                   dst_replica, dst_step, dst_slot, n_blocks):
        pass

    def on_refold_move(self, req, src_replica, dst_replica):
        pass

    def wall(self):
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Collects spans/events/step records from engines and the cluster
    router.  One tracer instance may be shared by many replicas — each
    hook takes the calling replica's index.

    The engine-step clock is **per replica** (each engine counts its own
    dispatches); the exporter keeps replicas on separate process rows so
    the clocks never mix.  ``wall=True`` additionally stamps every record
    with ``time.perf_counter()`` for cross-replica alignment.
    """

    enabled = True

    def __init__(self, wall: bool = False, slo=None):
        self.use_wall = wall
        self.slo = slo                          # optional SLOMonitor
        self.spans: list[Span] = []
        self.events: list[Event] = []
        self.steps: list = []                   # StepRecord, append order
        self.requests: dict[tuple[int, int], _RequestState] = {}
        self.round = 0                          # cluster round (set by Cluster)
        # (replica, step) -> wall stamp of that step's *dispatch*, so
        # observe-time closes (async lands them a step later) can carry
        # both stamps and trace viewers see the true overlap
        self._step_wall: dict[tuple[int, int], float] = {}

    def wall(self) -> float | None:
        return time.perf_counter() if self.use_wall else None

    def _dispatch_wall(self, replica: int, step: int) -> float | None:
        return self._step_wall.get((replica, step)) if self.use_wall else None

    # ------------------------------------------------------ request lifecycle
    def _state(self, replica: int, req) -> _RequestState:
        key = (replica, req.uid)
        st = self.requests.get(key)
        if st is None:
            st = _RequestState(uid=req.uid, replica=replica, submit_step=0,
                               prompt_len=len(req.prompt))
            self.requests[key] = st
        return st

    def _event(self, replica, track, uid, name, step, **attrs) -> None:
        self.events.append(Event(replica=replica, track=track, uid=uid,
                                 name=name, step=step, t=self.wall(),
                                 attrs=attrs))

    def on_submit(self, replica: int, req, step: int) -> None:
        st = self._state(replica, req)
        st.submit_step = step
        st.queued = Span(replica=replica, track=TRACK_QUEUE, uid=req.uid,
                         name="queued", start=step, t_start=self.wall(),
                         attrs={"prompt_len": len(req.prompt)})
        self.spans.append(st.queued)

    def on_admit(self, replica: int, req, step: int, slot: int,
                 n_tokens: int, refold: bool = False) -> None:
        """Close the queued span; a re-admission after preemption also
        emits ``refolded`` (generated tokens folded into the prefill)."""
        st = self._state(replica, req)
        if st.queued is not None and not st.queued.closed:
            st.queued.end = step
            st.queued.t_end = self.wall()
        st.queued = None
        self._event(replica, slot, req.uid, "admitted", step,
                    slot=slot, n_tokens=n_tokens)
        if refold:
            self._event(replica, slot, req.uid, "refolded", step,
                        slot=slot, n_tokens=n_tokens)

    def on_chunk(self, replica: int, req, slot: int, start_step: int,
                 end_step: int, pos: int, n_valid: int,
                 bucket: int | None, last: bool) -> None:
        """One executed prefill chunk (a whole decode-only prefill is one
        chunk covering its ceil(L/prefill_chunk)-step cost)."""
        attrs = {"pos": pos, "n_valid": n_valid, "bucket": bucket,
                 "last": last}
        wd = self._dispatch_wall(replica, end_step)
        if wd is not None:
            attrs["wall_dispatch"] = wd
        self.spans.append(Span(
            replica=replica, track=slot, uid=req.uid, name="prefill_chunk",
            start=start_step, end=end_step, t_end=self.wall(), attrs=attrs,
        ))

    def on_first_token(self, replica: int, req, step: int, slot: int,
                       first: bool = True) -> None:
        """Prefill completed: open the decode span.  ``first`` is False on
        a post-preemption re-admission (the true first token was already
        emitted before the preemption)."""
        st = self._state(replica, req)
        if first:
            self._event(replica, slot, req.uid, "first_token", step,
                        slot=slot)
            if self.slo is not None:
                ttft = max(step - st.submit_step, 0)
                if self.slo.observe_ttft(req.uid, ttft):
                    self._event(replica, slot, req.uid, "slo_breach", step,
                                metric="ttft", value=ttft,
                                target=self.slo.ttft_target)
        st.decode = Span(replica=replica, track=slot, uid=req.uid,
                         name="decode", start=step, t_start=self.wall())
        wd = self._dispatch_wall(replica, step)
        if wd is not None:
            st.decode.attrs["wall_dispatch"] = wd
        self.spans.append(st.decode)

    def on_finish(self, replica: int, req, step: int, slot: int) -> None:
        st = self._state(replica, req)
        wd = self._dispatch_wall(replica, step)
        if st.decode is not None and not st.decode.closed:
            st.decode.end = step
            st.decode.t_end = self.wall()
            st.decode.attrs["generated"] = len(req.out_tokens)
            if wd is not None:
                # async closes land at observe time, one step after the
                # dispatch that produced the final token: record both
                # stamps so viewers can show the true device overlap
                st.decode.attrs["wall_dispatch"] = wd
        st.decode = None
        st.finished = True
        attrs = {"generated": len(req.out_tokens)}
        if wd is not None:
            attrs["wall_dispatch"] = wd
        self._event(replica, slot, req.uid, "finish", step, **attrs)
        if self.slo is not None:
            gen = len(req.out_tokens)
            first_step = getattr(req, "first_token_step", -1)
            tpot = ((step - first_step) / max(gen - 1, 1)
                    if 0 <= first_step <= step else 0.0)
            if self.slo.observe_finish(req.uid, tpot, gen):
                self._event(replica, slot, req.uid, "slo_breach", step,
                            metric="tpot", value=tpot,
                            target=self.slo.tpot_target)

    def on_preempt(self, replica: int, req, step: int, slot: int) -> None:
        """Eviction to the queue: the decode span ends here (marked), and
        a fresh queued span opens — the request is waiting again."""
        st = self._state(replica, req)
        if st.decode is not None and not st.decode.closed:
            st.decode.end = step
            st.decode.t_end = self.wall()
            st.decode.attrs["preempted"] = True
            wd = self._dispatch_wall(replica, step)
            if wd is not None:
                st.decode.attrs["wall_dispatch"] = wd
        st.decode = None
        self._event(replica, slot, req.uid, "preempted", step, slot=slot)
        st.queued = Span(replica=replica, track=TRACK_QUEUE, uid=req.uid,
                         name="queued", start=step, t_start=self.wall(),
                         attrs={"requeued": True})
        self.spans.append(st.queued)

    def on_boundary_pack(self, replica: int, req, step: int, slot: int) -> None:
        self._event(replica, slot, req.uid, "boundary_packed", step,
                    slot=slot)

    # ------------------------------------------------------------ KV tiering
    def on_spill(self, replica: int, step: int, dev_block: int,
                 host_block: int) -> None:
        """One KV block copied device -> host tier (free-time or live
        spill).  Not tied to a request: stamped on the steps track."""
        self._event(replica, TRACK_STEPS, -1, "kv_spill", step,
                    dev=dev_block, host=host_block)

    def on_rehydrate(self, replica: int, step: int, host_block: int,
                     dev_block: int) -> None:
        """One KV block copied host tier -> device (prefix re-hydration)."""
        self._event(replica, TRACK_STEPS, -1, "kv_rehydrate", step,
                    host=host_block, dev=dev_block)

    # ------------------------------------------------- speculative decoding
    def on_spec_propose(self, replica: int, step: int, depth: int,
                        batch: int) -> None:
        """One speculative dispatch: ``depth`` draft tokens proposed per
        slot for ``batch`` decode slots.  Not tied to a request: stamped
        on the steps track at dispatch."""
        self._event(replica, TRACK_STEPS, -1, "spec_propose", step,
                    depth=depth, batch=batch)

    def on_spec_verify(self, replica: int, step: int, accepted: int,
                       batch: int) -> None:
        """One speculative window observed: ``accepted`` draft tokens
        (bonus tokens excluded) accepted across ``batch`` slots.  Stamped
        at the window's *dispatch* step (the pending record's clock), so
        propose/verify marks pair up on the timeline."""
        self._event(replica, TRACK_STEPS, -1, "spec_verify", step,
                    accepted=accepted, batch=batch)

    # ------------------------------------------------------------- timeline
    def on_step(self, record) -> None:
        """Append one per-dispatch StepRecord (built by the engine only
        when ``enabled`` — see ``Engine._trace_step``)."""
        self.steps.append(record)
        if record.wall is not None:
            self._step_wall[(record.replica, record.step)] = record.wall

    # --------------------------------------------------------------- router
    def on_route(self, uid: int, replica: int, policy: str, rank_pos: int,
                 hit_tokens: int, probed: int) -> None:
        """A cluster routing decision, stamped on the cluster round clock
        (``self.round``, maintained by ``Cluster.step``)."""
        self._event(-1, TRACK_ROUTER, uid, "route", self.round,
                    chosen=replica, policy=policy, spill=rank_pos > 0,
                    rank_pos=rank_pos, hit_tokens=hit_tokens, probed=probed)

    # ------------------------------------------------------------- migration
    def on_migrate(self, req, src_replica: int, src_step: int, src_slot: int,
                   dst_replica: int, dst_step: int, dst_slot: int,
                   n_blocks: int) -> None:
        """A resident request's KV migrated between replicas (the
        disaggregated prefill->decode handoff).  The source's decode span
        closes (``migrated=True``), a fresh decode span opens on the
        destination's clock, and three markers land: ``kv_migrate_out``
        on the source slot row, ``kv_migrate_in`` on the destination slot
        row, and the cluster-level ``kv_migrate`` mark on the router row
        (one per migration)."""
        src = self._state(src_replica, req)
        if src.decode is not None and not src.decode.closed:
            src.decode.end = src_step
            src.decode.t_end = self.wall()
            src.decode.attrs["migrated"] = True
            src.decode.attrs["dst_replica"] = dst_replica
        src.decode = None
        self._event(src_replica, src_slot, req.uid, "kv_migrate_out",
                    src_step, dst=dst_replica, blocks=n_blocks)
        key = (dst_replica, req.uid)
        dst = self.requests.get(key)
        if dst is None:
            dst = _RequestState(uid=req.uid, replica=dst_replica,
                                submit_step=dst_step,
                                prompt_len=len(req.prompt))
            self.requests[key] = dst
        dst.migrated_in = True
        dst.decode = Span(replica=dst_replica, track=dst_slot, uid=req.uid,
                          name="decode", start=dst_step, t_start=self.wall(),
                          attrs={"migrated_in": True, "src_replica": src_replica})
        self.spans.append(dst.decode)
        self._event(dst_replica, dst_slot, req.uid, "kv_migrate_in",
                    dst_step, src=src_replica, blocks=n_blocks)
        self._event(-1, TRACK_ROUTER, req.uid, "kv_migrate", self.round,
                    src=src_replica, dst=dst_replica, blocks=n_blocks)

    def on_refold_move(self, req, src_replica: int, dst_replica: int) -> None:
        """A preempted request's refold re-placed off its home replica
        (router-driven refold placement), marked on the router row."""
        self._event(-1, TRACK_ROUTER, req.uid, "refold_move", self.round,
                    src=src_replica, dst=dst_replica)
        # the request now queues on the destination: close any open
        # queued span at home and open one there
        src = self._state(src_replica, req)
        if src.queued is not None and not src.queued.closed:
            src.queued.end = src.queued.start
            src.queued.t_end = self.wall()
            src.queued.attrs["moved"] = True
        src.queued = None
        dst = self._state(dst_replica, req)
        dst.migrated_in = True
        dst.queued = Span(replica=dst_replica, track=TRACK_QUEUE, uid=req.uid,
                          name="queued", start=req.submit_step,
                          t_start=self.wall(), attrs={"refold_move": True})
        self.spans.append(dst.queued)

    # ---------------------------------------------------------- introspection
    def replicas(self) -> list[int]:
        """Replica indices that produced any record (cluster row -1 excluded)."""
        seen = {s.replica for s in self.spans}
        seen |= {e.replica for e in self.events}
        seen |= {r.replica for r in self.steps}
        return sorted(i for i in seen if i >= 0)
