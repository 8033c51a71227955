"""Token-budget iteration scheduler (Sarathi-style chunked prefill).

A copy of ``repro.serving.scheduler`` (pure host-side Python); the port
keeps its own so that it imports nothing of ``repro``.  It makes the
reference's decisions, without its chunk buckets: the engine runs every
chunk at one shape (``prefill_chunk``), so that a token's numerics do not
depend on where a chunk boundary falls.  The decode-only engine uses
only its queue.

The paper's headline gain comes from keeping the compute-bound and
memory-bound halves of the workload busy *simultaneously*: dense GEMMs on
the GPU while the HPU serves GEMV-shaped decode attention.  The serving
analogue is hybrid batching — each engine iteration carries one decode
token per active slot *plus* up to ``prefill_chunk`` tokens of the
head-of-queue prompt, so a prefill chunk rides along the decode batch's
weight stream instead of stalling it (HGCA / Sarathi-SC; PAPERS.md).

The :class:`Scheduler` owns the request queue and, each iteration, packs
that hybrid batch under a hard **token budget**:

* decode tokens always take priority — every active slot decodes every
  step (the fixed-shape decode batch cannot be split), and the budget
  must cover at least ``n_slots`` tokens;
* whatever budget remains funds at most one prefill chunk of the
  in-flight prompt, clipped to ``prefill_chunk``.

For the paged cache, non-final chunks are rounded down to end on a KV
block boundary (``block_size``), so a sequence acquires only the blocks
its next chunk needs — partial-prompt admission, shrinking the up-front
boundary-headroom reservation to the final chunk.

The scheduler is purely host-side bookkeeping: the engine executes the
:class:`Decision` (fused model step), then calls :meth:`advance` on the
chunk it actually ran (a paged engine may stall a chunk when the pool is
dry; the scheduler simply re-offers it next iteration).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any


@dataclasses.dataclass
class PrefillChunk:
    """One chunk of one prompt: positions [start, start + n_valid)."""

    req: Any
    slot: int
    start: int          # absolute position of the chunk's first token
    n_valid: int        # real tokens in the chunk
    last: bool          # completes the prompt -> sample the first token


@dataclasses.dataclass
class Decision:
    """What one engine iteration runs: the decode batch + one chunk."""

    decode_slots: list[int]
    prefill: PrefillChunk | None

    def tokens_packed(self) -> int:
        return len(self.decode_slots) + (
            self.prefill.n_valid if self.prefill is not None else 0
        )


@dataclasses.dataclass
class _Inflight:
    req: Any
    slot: int
    pos: int            # next unprefilled position
    total: int          # prompt length (incl. re-folded generated tokens)


class Scheduler:
    def __init__(
        self,
        n_slots: int,
        max_seq: int,
        mode: str = "decode-only",
        prefill_chunk: int = 32,
        token_budget: int | None = None,
        block_size: int | None = None,
        spec_width: int = 1,
    ):
        if mode not in ("decode-only", "hybrid"):
            raise ValueError(f"unknown schedule mode {mode!r}")
        if spec_width < 1:
            raise ValueError(f"spec_width must be >= 1, got {spec_width}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.mode = mode
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.block_size = block_size
        # speculative decoding makes every decode slot a (k+1)-position
        # verify, so each active slot charges spec_width = k+1 budget
        # tokens — a prefill chunk only gets what the verifies leave over
        self.spec_width = spec_width
        self.token_budget = (
            n_slots * spec_width + prefill_chunk
            if token_budget is None else token_budget
        )
        if self.token_budget < n_slots * spec_width:
            raise ValueError(
                f"token_budget={self.token_budget} cannot cover "
                f"{spec_width} verify position(s) per slot "
                f"(n_slots={n_slots}, spec_width={spec_width})"
            )
        if mode == "hybrid" and block_size is not None:
            if prefill_chunk < block_size or prefill_chunk % block_size:
                raise ValueError(
                    f"paged hybrid scheduling needs prefill_chunk "
                    f"({prefill_chunk}) to be a positive multiple of "
                    f"block_size ({block_size})"
                )
        self.queue: deque = deque()
        self.inflight: _Inflight | None = None

    # --------------------------------------------------------------- queue
    def submit(self, req) -> None:
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue) or self.inflight is not None

    def peek(self):
        return self.queue[0]

    def pop(self):
        return self.queue.popleft()

    def push_front(self, req) -> None:
        """Preempted requests rejoin at the head (exact-recovery FCFS)."""
        self.queue.appendleft(req)

    # ------------------------------------------------------------ chunking
    def begin(self, req, slot: int, start: int, total: int) -> None:
        """Pin ``req`` as the in-flight prefill on ``slot``; its first
        chunk starts at ``start`` (> 0 when a prompt prefix was served
        from the paged prefix cache)."""
        assert self.inflight is None, "one in-flight prefill at a time"
        self.inflight = _Inflight(req=req, slot=slot, pos=start, total=total)

    def schedule(self, active_slots: list[int]) -> Decision:
        """Pack one iteration: every active slot decodes; leftover budget
        funds one chunk of the in-flight prompt."""
        return self._pack(active_slots)

    def plan_ahead(self, planned_active: list[int]) -> Decision:
        """Async dispatch-ahead path: pack iteration *t+1* while iteration
        *t* is still executing on the device.

        Everything the packing reads is *planned*, not observed, state:
        ``planned_active`` is the engine's predicted active set (length /
        max-new retirements are host-deterministic at dispatch time; EOS
        retirements lag one step and are masked by the engine), and
        ``self.inflight`` already reflects chunks :meth:`advance`-d at
        their dispatch — the chunk *will* run, device data-flow ordering
        guarantees it, so host bookkeeping may run ahead of execution.
        The packing rule itself is identical to :meth:`schedule`; that is
        what keeps ``--async off`` greedy token-identical.
        """
        return self._pack(planned_active)

    def _pack(self, active_slots: list[int]) -> Decision:
        work = None
        if self.mode == "hybrid":
            work = self._make_chunk(
                self.token_budget - len(active_slots) * self.spec_width
            )
        return Decision(decode_slots=list(active_slots), prefill=work)

    def _make_chunk(self, budget: int) -> PrefillChunk | None:
        """Clip the in-flight prompt's next chunk to ``budget`` tokens."""
        fl = self.inflight
        if fl is None or budget <= 0:
            return None
        remaining = fl.total - fl.pos
        n = min(self.prefill_chunk, budget, remaining)
        if self.block_size is not None and 0 < n < remaining:
            # non-final chunks end on a KV block boundary so completed
            # blocks flush to the pool as they fill
            n = (fl.pos + n) // self.block_size * self.block_size - fl.pos
        if n <= 0:
            return None
        return PrefillChunk(
            req=fl.req, slot=fl.slot, start=fl.pos, n_valid=n,
            last=fl.pos + n == fl.total,
        )

    def pack_boundary(self, budget: int) -> PrefillChunk | None:
        """Sarathi-SC boundary packing: when one prompt's *final* partial
        chunk left part of the iteration's budget unused, fund the head
        chunk of the next prompt with the leftover — the engine calls
        this after :meth:`advance`-ing the final chunk and
        :meth:`begin`-ing the next prompt, still inside the same
        iteration, so the token budget stays full across prompt
        boundaries instead of idling for a step."""
        return self._make_chunk(budget)

    def advance(self, work: PrefillChunk) -> None:
        """Commit an executed chunk; the last chunk retires the in-flight
        entry (the engine then owns the now-decoding slot)."""
        fl = self.inflight
        assert fl is not None and fl.pos == work.start
        fl.pos = work.start + work.n_valid
        if work.last:
            self.inflight = None
