"""Seeded workload generator and round-clock driver.

Counterpart of ``repro.serving.workload`` for the ``random`` workload
(every request at round 0, prompt lengths uniform in ``[4, max_seq/2)``)
and :class:`WorkloadDriver`.  The same ``(n_requests, seed)`` yields
byte-identical prompts in both packages: both draw from
``numpy.random.default_rng(seed)`` in the same order.  The open-loop
kinds (poisson, bursty, chat-fan, rag, agentic) come with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.engine import Request

WORKLOADS = ("random",)


@dataclasses.dataclass
class Arrival:
    """One scheduled request: a prompt due at a driver round."""

    round: int
    prompt: np.ndarray
    max_new_tokens: int


def _prompt(rng: np.random.Generator, length: int, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, size=int(length)).astype(np.int32)


def build_workload(kind: str, n_requests: int, *, vocab: int, max_seq: int,
                   max_new: int, seed: int = 0) -> list[Arrival]:
    """Deterministic arrival schedule (sorted by round)."""
    if kind not in WORKLOADS:
        raise NotImplementedError(f"workload {kind!r} is not ported yet "
                                  f"(ported: {', '.join(WORKLOADS)})")
    rng = np.random.default_rng(seed)
    hi = max(5, max_seq // 2)
    out = []
    for _ in range(n_requests):
        plen = int(rng.integers(4, hi))
        out.append(Arrival(0, _prompt(rng, plen, vocab), max_new))
    return out


class WorkloadDriver:
    """Play an arrival schedule against an :class:`Engine` on its own
    round clock: each round submits the arrivals that are due and steps
    the engine once, until everything submitted has finished."""

    def __init__(self, serv, arrivals: list[Arrival]):
        self.serv = serv
        self.arrivals = sorted(arrivals, key=lambda a: a.round)
        self.submitted: list[Request] = []
        self.rounds = 0

    def run(self, max_rounds: int = 100_000) -> int:
        """Drive to completion; returns rounds elapsed."""
        i = 0
        while self.rounds < max_rounds:
            while i < len(self.arrivals) and self.arrivals[i].round <= self.rounds:
                arr = self.arrivals[i]
                req = Request(uid=len(self.submitted), prompt=arr.prompt,
                              max_new_tokens=arr.max_new_tokens)
                self.serv.submit(req)
                self.submitted.append(req)
                i += 1
            busy = self.serv.step()
            self.rounds += 1
            if not busy and i >= len(self.arrivals):
                break
        if self.serv.async_mode:
            self.serv._drain()          # settle the async pipeline
        return self.rounds
