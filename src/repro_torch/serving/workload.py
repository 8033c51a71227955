"""Deterministic seeded workload generator + open-loop arrival driver.

Counterpart of ``repro.serving.workload``: the same ``(kind, n, seed,
rate, burst, fan, turns)`` yields byte-identical prompts and rounds in
both packages (both draw from ``numpy.random.default_rng`` in the same
order), and :class:`WorkloadDriver` resubmits agentic sessions on the
same rounds.

Serving scenarios are not a list of prompts, they are *arrival
processes* with structure the cache can exploit (or be hurt by).
:func:`build_workload` produces a seeded, fully deterministic arrival
schedule in six shapes:

* ``random``   — every request at round 0, lengths uniform in
  ``[4, max_seq/2)``: the serve CLI's default;
* ``poisson``  — open-loop Poisson arrivals at ``rate`` requests/round
  (exponential inter-arrival gaps, cumulative-summed onto the round
  clock);
* ``bursty``   — the same mean rate delivered in bursts of ``burst``
  simultaneous requests: the head-of-line / queue-depth stress shape;
* ``chat-fan`` — groups of ``fan`` requests share one prompt prefix and
  arrive within a few rounds of each other (fan-out of one conversation
  to many users): the shape hash-based block sharing is built for;
* ``rag``      — a few long shared documents, each queried by many
  requests with short unique suffixes: long-prefix reuse with
  decode-light tails;
* ``agentic``  — tool-loop sessions: the initial request is short, and
  every completion is resubmitted by the driver with the prior output
  folded into a **grown prefix** plus a fresh query (``turns`` rounds of
  this per session).

:class:`WorkloadDriver` plays a schedule against an :class:`Engine` on
its own round clock: arrivals are submitted
when their round comes up, agentic completions are resubmitted after a
``think`` delay, and the run ends only when every submitted request —
including grown resubmissions — has finished.  Grown prefixes are
clipped to a tail window so prompt + generation always fits ``max_seq``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.engine import Request

WORKLOADS = ("random", "poisson", "bursty", "chat-fan", "rag", "agentic")


@dataclasses.dataclass
class Arrival:
    """One scheduled request: a prompt due at a cluster round.  The
    driver assigns uids at submission (sessions respawn with fresh
    uids, so generator-side ids would collide)."""

    round: int
    prompt: np.ndarray
    max_new_tokens: int
    session: int = -1           # agentic session id (-1: one-shot)
    turns_left: int = 0         # resubmissions still owed by the session


def _prompt(rng: np.random.Generator, length: int, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, size=int(length)).astype(np.int32)


def _poisson_rounds(rng: np.random.Generator, n: int, rate: float) -> list[int]:
    gaps = rng.exponential(1.0 / max(rate, 1e-6), size=n)
    return [int(r) for r in np.floor(np.cumsum(gaps))]


def build_workload(kind: str, n_requests: int, *, vocab: int, max_seq: int,
                   max_new: int, seed: int = 0, rate: float = 0.5,
                   burst: int = 4, fan: int = 4,
                   turns: int = 3) -> list[Arrival]:
    """Build a deterministic arrival schedule (sorted by round).

    ``rate`` paces the open-loop kinds in requests/round; ``burst``,
    ``fan`` and ``turns`` shape their namesake kinds.  Prompt lengths
    respect ``len(prompt) + max_new <= max_seq - 2`` so every arrival
    (and every grown agentic resubmission) is admissible.
    """
    if kind not in WORKLOADS:
        raise ValueError(f"unknown workload {kind!r} (known: "
                         f"{', '.join(WORKLOADS)})")
    rng = np.random.default_rng(seed)
    budget = max(6, max_seq - max_new - 2)
    out: list[Arrival] = []

    if kind == "random":
        hi = max(5, max_seq // 2)
        for _ in range(n_requests):
            plen = int(rng.integers(4, hi))
            out.append(Arrival(0, _prompt(rng, plen, vocab), max_new))

    elif kind == "poisson":
        rounds = _poisson_rounds(rng, n_requests, rate)
        hi = max(5, min(max_seq // 2, budget))
        for r in rounds:
            plen = int(rng.integers(4, hi))
            out.append(Arrival(r, _prompt(rng, plen, vocab), max_new))

    elif kind == "bursty":
        gap = max(1, round(burst / max(rate, 1e-6)))
        hi = max(5, min(max_seq // 2, budget))
        for i in range(n_requests):
            plen = int(rng.integers(4, hi))
            out.append(Arrival((i // burst) * gap,
                               _prompt(rng, plen, vocab), max_new))

    elif kind == "chat-fan":
        prefix_len = max(4, budget // 3)
        suffix_hi = max(3, budget // 6)
        group_rounds = _poisson_rounds(rng, -(-n_requests // fan),
                                       rate / max(fan, 1))
        for g, r0 in enumerate(group_rounds):
            prefix = _prompt(rng, prefix_len, vocab)
            for _ in range(min(fan, n_requests - g * fan)):
                suffix = _prompt(rng, int(rng.integers(2, suffix_hi + 1)),
                                 vocab)
                out.append(Arrival(r0 + int(rng.integers(0, 3)),
                                   np.concatenate([prefix, suffix]),
                                   max_new))

    elif kind == "rag":
        doc_len = max(6, (budget * 3) // 5)
        n_docs = max(1, n_requests // 6)
        docs = [_prompt(rng, doc_len, vocab) for _ in range(n_docs)]
        rounds = _poisson_rounds(rng, n_requests, rate)
        q_hi = max(3, min(8, budget - doc_len))
        for r in rounds:
            doc = docs[int(rng.integers(0, n_docs))]
            query = _prompt(rng, int(rng.integers(2, q_hi + 1)), vocab)
            out.append(Arrival(r, np.concatenate([doc, query]), max_new))

    elif kind == "agentic":
        rounds = _poisson_rounds(rng, n_requests, rate)
        hi = max(5, budget // 4)
        for s, r in enumerate(rounds):
            plen = int(rng.integers(4, hi))
            out.append(Arrival(r, _prompt(rng, plen, vocab), max_new,
                               session=s, turns_left=max(turns - 1, 0)))

    out.sort(key=lambda a: a.round)
    return out


def grow_prompt(prompt: np.ndarray, out_tokens: list[int],
                query: np.ndarray, max_seq: int,
                max_new: int) -> np.ndarray:
    """Agentic resubmission prompt: prior prompt + prior output + a new
    query, clipped to a *tail* window (the sliding-context convention)
    so the grown prompt plus the next generation still fits ``max_seq``."""
    grown = np.concatenate([
        prompt, np.asarray(out_tokens, dtype=np.int32), query
    ]).astype(np.int32)
    budget = max(4, max_seq - max_new - 2)
    return grown[-budget:] if len(grown) > budget else grown


class WorkloadDriver:
    """Play an arrival schedule against one
    :class:`~repro_torch.serving.engine.Engine` on its own clock.

    Each driver round submits the arrivals that are due, steps the
    server once, and harvests finished agentic sessions into grown-
    prefix resubmissions due ``think`` rounds later.  ``on_round``
    (e.g. the ``--dashboard`` renderer) fires after every round.
    """

    def __init__(self, serv, arrivals: list[Arrival], *, vocab: int,
                 max_seq: int, seed: int = 0, think: int = 2,
                 on_round=None):
        self.serv = serv
        self.arrivals = sorted(arrivals, key=lambda a: a.round)
        self.rng = np.random.default_rng(seed + 0x5EED)
        self.vocab = vocab
        self.max_seq = max_seq
        self.think = think
        self.on_round = on_round
        self.submitted: list[Request] = []
        self.resubmits = 0
        self.rounds = 0
        self._next_uid = 0
        # uid -> originating Arrival, parked until the request finishes
        self._sessions: dict[int, tuple[Request, Arrival]] = {}

    def _submit(self, arr: Arrival) -> None:
        req = Request(uid=self._next_uid, prompt=arr.prompt,
                      max_new_tokens=arr.max_new_tokens)
        self._next_uid += 1
        self.serv.submit(req)
        self.submitted.append(req)
        if arr.turns_left > 0:
            self._sessions[req.uid] = (req, arr)

    def _grow(self, req: Request, arr: Arrival) -> Arrival:
        query = self.rng.integers(1, self.vocab,
                                  size=int(self.rng.integers(2, 7)))
        prompt = grow_prompt(req.prompt, req.out_tokens,
                             query.astype(np.int32), self.max_seq,
                             arr.max_new_tokens)
        self.resubmits += 1
        return Arrival(round=self.rounds + self.think, prompt=prompt,
                       max_new_tokens=arr.max_new_tokens,
                       session=arr.session, turns_left=arr.turns_left - 1)

    def run(self, max_rounds: int = 100_000) -> int:
        """Drive until every arrival (and every agentic resubmission)
        has been submitted and finished; returns rounds elapsed."""
        i = 0
        followups: list[Arrival] = []
        while self.rounds < max_rounds:
            while i < len(self.arrivals) and \
                    self.arrivals[i].round <= self.rounds:
                self._submit(self.arrivals[i])
                i += 1
            due = [a for a in followups if a.round <= self.rounds]
            if due:
                followups = [a for a in followups if a.round > self.rounds]
                for a in due:
                    self._submit(a)
            busy = self.serv.step()
            finished = [uid for uid, (req, _) in self._sessions.items()
                        if req.done]
            for uid in finished:
                req, arr = self._sessions.pop(uid)
                followups.append(self._grow(req, arr))
            self.rounds += 1
            if self.on_round is not None:
                self.on_round(self.rounds)
            if (not busy and i >= len(self.arrivals) and not followups
                    and not self._sessions):
                break
        # settle the async pipeline (as Engine.run does), then take any
        # first token still pending, in the reference driver's order
        if self.serv.async_mode:
            self.serv._drain()
        self.serv._flush_first()
        return self.rounds


__all__ = ["WORKLOADS", "Arrival", "WorkloadDriver", "build_workload",
           "grow_prompt"]
