"""SLO attainment monitor: declared latency targets, goodput, breach marks.

A copy of ``repro.serving.telemetry.slo`` (pure Python).

Serving papers judge systems on *attainment*, not means: what fraction
of requests met a declared time-to-first-token (TTFT) and
time-per-output-token (TPOT) target, and how many tokens per unit time
were produced by requests that did (**goodput** — tokens from
SLO-violating requests are wasted work).  :class:`SLOMonitor` computes
exactly that over the engine-step clock:

* **TTFT** = first-token step − submit step (per replica engine clock,
  the same clock as the ``ttft_steps`` registry histogram);
* **TPOT** = (finish step − first-token step) / max(generated − 1, 1);
* a request **attains** its SLO when both observed values are within
  their targets (an unset target always passes);
* **goodput** = tokens generated by attaining requests / elapsed rounds.

Sliding windows (``window`` most recent samples) give the live p50/p99
view a long run needs — cumulative percentiles bury a latency regression
under history — while attainment and goodput stay cumulative.

The monitor is driven by the tracer (``Tracer(slo=monitor)`` forwards
``on_first_token`` / ``on_finish``), which also drops an ``slo_breach``
instant mark on the offending request's slot row the moment a target is
missed.
:meth:`SLOMonitor.from_spans` replays a recorded (or hand-built) span
set through the same arithmetic, so attainment is testable without an
engine.
"""
from __future__ import annotations

from collections import deque

from repro_torch.serving.telemetry.metrics import percentile


class SLOMonitor:
    """Sliding-window TTFT/TPOT percentiles, attainment, and goodput
    against declared targets (``None`` target = always attained)."""

    def __init__(self, ttft_target: float | None = None,
                 tpot_target: float | None = None, window: int = 256):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self.window = window
        self.ttft_samples: deque[float] = deque(maxlen=window)
        self.tpot_samples: deque[float] = deque(maxlen=window)
        self._window_ok: deque[bool] = deque(maxlen=window)
        self.finished = 0
        self.attained_count = 0
        self.breaches = 0
        self.good_tokens = 0
        self.total_tokens = 0
        # uid -> TTFT verdict, parked between first token and finish
        self._ttft_ok: dict[int, bool] = {}

    # ---------------------------------------------------------- observation
    def observe_ttft(self, uid: int, ttft: float) -> bool:
        """Record one request's TTFT; returns True on a breach."""
        self.ttft_samples.append(float(ttft))
        ok = self.ttft_target is None or ttft <= self.ttft_target
        self._ttft_ok[uid] = ok
        if not ok:
            self.breaches += 1
        return not ok

    def observe_finish(self, uid: int, tpot: float, tokens: int) -> bool:
        """Record one request's decode-phase TPOT and token count at
        finish; returns True on a TPOT breach.  The request attains its
        SLO only if its parked TTFT verdict also passed."""
        self.tpot_samples.append(float(tpot))
        tpot_ok = self.tpot_target is None or tpot <= self.tpot_target
        ok = tpot_ok and self._ttft_ok.pop(uid, True)
        self.finished += 1
        self.total_tokens += tokens
        if ok:
            self.attained_count += 1
            self.good_tokens += tokens
        self._window_ok.append(ok)
        if not tpot_ok:
            self.breaches += 1
        return not tpot_ok

    # ------------------------------------------------------------ reporting
    @property
    def attainment(self) -> float:
        """Cumulative fraction of finished requests inside both targets."""
        return self.attained_count / max(self.finished, 1)

    @property
    def window_attainment(self) -> float:
        """Attainment over the ``window`` most recent finishes."""
        return sum(self._window_ok) / max(len(self._window_ok), 1)

    def ttft_percentile(self, p: float) -> float:
        return percentile(list(self.ttft_samples), p)

    def tpot_percentile(self, p: float) -> float:
        return percentile(list(self.tpot_samples), p)

    def goodput(self, elapsed: float) -> float:
        """SLO-satisfying tokens per elapsed clock unit (rounds for a
        cluster, engine steps for a single engine)."""
        return self.good_tokens / max(elapsed, 1)

    def register(self, reg, elapsed: float | None = None) -> None:
        """Publish the attainment/goodput section into a
        :class:`MetricsRegistry` snapshot."""
        if self.ttft_target is not None:
            reg.gauge("slo_ttft_target").set(self.ttft_target)
        if self.tpot_target is not None:
            reg.gauge("slo_tpot_target").set(self.tpot_target)
        reg.counter("slo_finished").inc(self.finished)
        reg.counter("slo_attained").inc(self.attained_count)
        reg.counter("slo_breaches").inc(self.breaches)
        reg.counter("slo_good_tokens").inc(self.good_tokens)
        reg.gauge("slo_attainment").set(self.attainment)
        reg.gauge("slo_window_attainment").set(self.window_attainment)
        reg.histogram("slo_ttft").extend(self.ttft_samples)
        reg.histogram("slo_tpot").extend(self.tpot_samples)
        if elapsed is not None:
            reg.gauge("slo_goodput_tokens_per_round").set(
                self.goodput(elapsed)
            )

    def describe(self) -> str:
        """One-line attainment summary for the terminal dashboard."""
        tgt = (f"ttft<={self.ttft_target} " if self.ttft_target is not None
               else "") + (f"tpot<={self.tpot_target}" if self.tpot_target
                           is not None else "")
        return (f"slo[{tgt.strip() or 'none'}]: att={self.attainment:.2f} "
                f"(win {self.window_attainment:.2f}) "
                f"ttft p50/p99 {self.ttft_percentile(50):.0f}/"
                f"{self.ttft_percentile(99):.0f} "
                f"tpot p99 {self.tpot_percentile(99):.2f} "
                f"breaches={self.breaches} finished={self.finished}")

    # -------------------------------------------------------------- replay
    @classmethod
    def from_spans(cls, spans, ttft_target: float | None = None,
                   tpot_target: float | None = None,
                   window: int = 256) -> "SLOMonitor":
        """Replay a span set (recorded or hand-built) through the
        attainment arithmetic: each request's ``queued`` span gives the
        submit step, its last closed ``decode`` span gives first-token
        and finish steps plus the generated count (``attrs["generated"]``).
        Requests without a closed decode span never finished and are
        skipped."""
        mon = cls(ttft_target=ttft_target, tpot_target=tpot_target,
                  window=window)
        submit: dict[int, int] = {}
        first: dict[int, int] = {}      # earliest decode start (true TTFT
        last: dict[int, object] = {}    # even across preemption re-opens)
        for s in spans:
            if s.name == "queued":
                submit[s.uid] = min(submit.get(s.uid, s.start), s.start)
            elif s.name == "decode" and s.end is not None:
                first[s.uid] = min(first.get(s.uid, s.start), s.start)
                prev = last.get(s.uid)
                if prev is None or s.end >= prev.end:
                    last[s.uid] = s
        for uid in sorted(last):
            d = last[uid]
            f = first[uid]
            gen = int(d.attrs.get("generated", 1))
            mon.observe_ttft(uid, f - submit.get(uid, f))
            mon.observe_finish(uid, (d.end - f) / max(gen - 1, 1), gen)
        return mon


__all__ = ["SLOMonitor"]
