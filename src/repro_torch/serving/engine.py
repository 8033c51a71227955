"""Continuous-batching serving engine: dense KV cache, decode-only schedule.

Counterpart of ``repro.serving.engine`` for ``cache_kind="dense"`` and
``schedule="decode-only"``, in both execution modes; the paged cache,
the hybrid schedule, speculation and sub-batch pipelining raise
``NotImplementedError`` until their slices are ported.

Slot-based continuous batching (Orca-style): a fixed decode batch of
``n_slots`` sequences; a finished sequence frees its slot and the next
queued request is prefilled into it (one whole-prompt prefill) while the
others keep decoding.

* ``async_mode=False`` — synchronous: every decode step's logits come
  back to the host and are sampled there (:func:`sampler.sample`).
* ``async_mode=True`` (default) — dispatch-ahead: each step samples on
  the device and feeds its ``(B,)`` token ids to the next step through
  the device-resident ``tok_state``.  CUDA stream order takes the place
  of JAX's async dispatch: step *t+1* is enqueued before step *t*'s ids
  are read, and those ids travel by a non-blocking copy into pinned
  memory with a CUDA event, waited on only after *t+1* is in flight.
  Length and max-new retirements are known on the host at dispatch; EOS
  is seen one step late, and the one token dispatched past an EOS is
  masked.  Greedy output is token-identical to sync mode.

Step accounting (``EngineStats.engine_steps``) matches the reference: a
decode step is one step, a whole prefill of ``L`` tokens costs
``ceil(L / prefill_chunk)`` steps.

Admission writes the prompt's K/V straight into the slot's stripe of the
shared cache (a view), after zeroing that stripe — the same contents the
reference gets by prefilling a fresh batch-1 cache and copying the whole
stripe in.  A released slot is zeroed as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serving import kv_cache
from repro_torch.serving.sampler import SamplerConfig, sample, sample_on_device
from repro_torch.serving.scheduler import Scheduler

Pytree = Any


def percentile(samples, p: float) -> float:
    """Exact nearest-rank percentile over raw samples (a copy of
    ``repro.serving.telemetry.metrics.percentile``): no samples -> 0.0,
    ``p`` outside [0, 100] clamps to the min/max sample."""
    s = sorted(samples)
    if not s:
        return 0.0
    p = min(max(p, 0.0), 100.0)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[min(rank, len(s)) - 1])


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    eos_id: int = -1                # -1: never stops early
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # latency accounting, in engine steps (-1 = not reached yet)
    submit_step: int = 0
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    # async bookkeeping: dispatched-but-unobserved tokens (one per step:
    # the reference's separate per-step count differs only under
    # speculation, which is not ported)
    in_flight: int = 0
    admit_base: int = 0             # len(out_tokens) at last admission


@dataclasses.dataclass
class EngineStats:
    """Field for field the reference's ``EngineStats``; the fields of
    features not ported yet stay 0."""

    prefills: int = 0
    prefill_chunks: int = 0
    boundary_packs: int = 0
    decode_steps: int = 0
    engine_steps: int = 0
    generated: int = 0
    peak_active: int = 0
    preemptions: int = 0
    victim_drains: int = 0
    spills: int = 0
    rehydrations: int = 0
    migrations_out: int = 0
    migrations_in: int = 0
    spec_steps: int = 0
    draft_steps: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    ttft_steps_sum: int = 0
    ttft_count: int = 0
    ttft_samples: list[int] = dataclasses.field(default_factory=list)
    per_token_samples: list[float] = dataclasses.field(default_factory=list)
    spec_accept_samples: list[float] = dataclasses.field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.drafted_tokens, 1)

    @property
    def mean_ttft_steps(self) -> float:
        return self.ttft_steps_sum / max(self.ttft_count, 1)

    @property
    def tokens_per_step(self) -> float:
        return self.generated / max(self.engine_steps, 1)

    def ttft_percentile(self, p: float) -> float:
        return percentile(self.ttft_samples, p)

    @property
    def ttft_p50_steps(self) -> float:
        return self.ttft_percentile(50)

    @property
    def ttft_p99_steps(self) -> float:
        return self.ttft_percentile(99)

    def per_token_percentile(self, p: float) -> float:
        return percentile(self.per_token_samples, p)


class _Fetch:
    """Small device tensors on their way to the host.  On CUDA: a
    non-blocking copy into pinned memory plus an event, enqueued in
    stream order; :meth:`numpy` waits on that event only."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.clone() for t in tensors]

    def numpy(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


@dataclasses.dataclass
class _PendingStep:
    """One dispatched-but-unobserved decode step.  ``reqs`` pins the
    requests in the batch at dispatch (a slot may be re-admitted to
    another request before the step is observed)."""

    step: int                            # engine_steps value at dispatch
    reqs: dict[int, Request]             # slot -> request in decode batch
    fetch: _Fetch                        # (B,) sampled ids, (B,) EOS hits


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting on the device (pinned
    staging + non-blocking copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class Engine:
    def __init__(
        self,
        model: Model,
        params: Pytree,
        n_slots: int,
        max_seq: int,
        sampler: SamplerConfig = SamplerConfig(),
        sub_batches: int = 1,
        seed: int = 0,
        cache_kind: str = "dense",
        schedule: str = "decode-only",
        prefill_chunk: int = 32,
        async_mode: bool = True,
        spec_depth: int = 0,
    ):
        if cache_kind != "dense":
            raise NotImplementedError(f"cache_kind={cache_kind!r} is not ported yet")
        if schedule != "decode-only":
            raise NotImplementedError(f"schedule={schedule!r} is not ported yet")
        if spec_depth:
            raise NotImplementedError("speculative decoding is not ported yet")
        if sub_batches != 1:
            raise NotImplementedError("sub-batch pipelining is not ported yet")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_seq = max_seq
        self.sampler = sampler
        self.prefill_chunk = prefill_chunk
        self.async_mode = async_mode
        self.slots: list[Request | None] = [None] * n_slots
        self.stats = EngineStats()
        # explicit generators: one on the device for the fused sampler,
        # one on the host for the synchronous oracle sampler
        self._gen_dev = torch.Generator(device=self.device).manual_seed(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        self.cache = model.init_cache(n_slots, max_seq)
        self._pending: deque[_PendingStep] = deque()
        self._first_pending: list[tuple[Request, _Fetch]] = []
        if async_mode:
            self._tok_state = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
            self._eos_dev = torch.full((n_slots,), -1, dtype=torch.int32,
                                       device=self.device)
        self.sched = Scheduler(n_slots=n_slots, max_seq=max_seq, mode=schedule,
                               prefill_chunk=prefill_chunk)

    # ------------------------------------------------------------- requests
    def submit(self, req: Request):
        if len(req.prompt) >= self.max_seq - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit max_seq="
                f"{self.max_seq}: admission needs len(prompt) <= max_seq - 2 "
                "so the cache holds the prompt plus at least one generated "
                "token without overflowing mid-decode"
            )
        req.submit_step = self.stats.engine_steps
        self.sched.submit(req)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    # --------------------------------------------- async pipeline primitives
    def _predicted_done(self, req: Request) -> bool:
        """Will the sync engine have marked ``req`` done once every
        dispatched token is observed?  The first token after admission
        comes from the prefill and is never length-checked."""
        c = len(req.out_tokens) + req.in_flight
        if c < req.admit_base + 2:
            return False
        return c >= req.max_new_tokens or len(req.prompt) + c >= self.max_seq - 1

    def _predicted_active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not self._predicted_done(s)]

    def _dispatch(self, rec: _PendingStep) -> None:
        """Queue a dispatched step; observe the previous one only after
        the new one is in flight."""
        self._pending.append(rec)
        if len(self._pending) > 1:
            self._observe(self._pending.popleft())

    def _flush_first(self) -> None:
        for req, fetch in self._first_pending:
            req.in_flight -= 1
            req.out_tokens.append(int(fetch.numpy()[0][0]))
        self._first_pending.clear()

    def _observe(self, rec: _PendingStep) -> None:
        """Read one step's ids and EOS flags and apply completions.  An
        EOS found here is one step late: the token a later in-flight step
        sampled for the now-done request is masked (``req.done``)."""
        self._flush_first()
        toks, eos = rec.fetch.numpy()
        for i, req in rec.reqs.items():
            req.in_flight -= 1
            if req.done:
                continue            # token dispatched past EOS: masked
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.stats.generated += 1
            length = len(req.prompt) + len(req.out_tokens)
            if (bool(eos[i]) or len(req.out_tokens) >= req.max_new_tokens
                    or length >= self.max_seq - 1):
                self._finish(i, req, rec.step)

    def _drain(self) -> None:
        """Observe every in-flight step (``out_tokens`` become exact)."""
        while self._pending:
            self._observe(self._pending.popleft())
        self._flush_first()

    def _finish(self, slot: int, req: Request, step: int) -> None:
        req.done = True
        req.finish_step = step
        n_decode_tokens = len(req.out_tokens) - 1
        if n_decode_tokens > 0 and req.first_token_step >= 0:
            self.stats.per_token_samples.append(
                (req.finish_step - req.first_token_step) / n_decode_tokens
            )
        if self.slots[slot] is req:
            self.slots[slot] = None
            kv_cache.reset_slot(self.cache, slot)

    # ------------------------------------------------------------ admission
    def _prefill_cost(self, n_tokens: int) -> int:
        """Whole-prefill step cost, in fixed hybrid-batch units."""
        return max(1, -(-n_tokens // self.prefill_chunk))

    def _admit(self):
        for slot in self._free_slots():
            if not len(self.sched):
                break
            req = self.sched.pop()
            self.stats.engine_steps += self._prefill_cost(len(req.prompt))
            if req.admit_step < 0:
                req.admit_step = self.stats.engine_steps
            prompt = _to_device(np.asarray(req.prompt, np.int64)[None], self.device)
            kv_cache.reset_slot(self.cache, slot)
            logits, _ = self.model.prefill(self.params, prompt,
                                           kv_cache.slot_view(self.cache, slot))
            self.slots[slot] = req
            self._sample_prefill(req, slot, logits)

    def _sample_prefill(self, req: Request, slot: int, logits: torch.Tensor):
        req.admit_base = len(req.out_tokens)
        if self.async_mode:
            # sample on the device and feed tok_state; the id is read
            # lazily with the step stream, the host never waits here
            tok = sample_on_device(logits, self._gen_dev, self.sampler)
            self._tok_state[slot:slot + 1].copy_(tok)
            self._eos_dev[slot] = req.eos_id
            req.in_flight += 1
            self._first_pending.append((req, _Fetch(tok)))
        else:
            req.out_tokens.append(int(sample(logits, self._gen_host, self.sampler)[0]))
        self._record_first_token(req)

    def _record_first_token(self, req: Request) -> None:
        if req.first_token_step < 0:
            req.first_token_step = self.stats.engine_steps
            ttft = req.first_token_step - req.submit_step
            self.stats.ttft_steps_sum += ttft
            self.stats.ttft_count += 1
            self.stats.ttft_samples.append(ttft)
        self.stats.prefills += 1
        self.stats.generated += 1

    # ----------------------------------------------------------------- step
    def _decode_tokens(self) -> torch.Tensor:
        tokens = np.zeros((len(self.slots),), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None and req.out_tokens:
                tokens[i] = req.out_tokens[-1]
        return _to_device(tokens, self.device)

    def _finish_decode(self, active: list[int], logits: torch.Tensor):
        next_host = sample(logits, self._gen_host, self.sampler).numpy()
        for i in active:
            req = self.slots[i]
            tok = int(next_host[i])
            req.out_tokens.append(tok)
            self.stats.generated += 1
            length = len(req.prompt) + len(req.out_tokens)
            if (tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens
                    or length >= self.max_seq - 1):
                self._finish(i, req, self.stats.engine_steps)

    def step(self) -> bool:
        """One engine iteration.  Returns whether any work remains."""
        if self.async_mode:
            return self._step_decode_only_async()
        return self._step_decode_only()

    def _step_decode_only(self) -> bool:
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return self.sched.has_work()
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    self._decode_tokens())
        self.stats.decode_steps += 1
        self.stats.engine_steps += 1
        self._finish_decode(active, logits)
        return any(s is not None for s in self.slots) or self.sched.has_work()

    def _step_decode_only_async(self) -> bool:
        self._admit()
        active = self._predicted_active()
        if not active:
            self._drain()               # nothing to dispatch: settle state
            return any(s is not None for s in self.slots) or self.sched.has_work()
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        toks, eos, self.cache = self.model.decode_sample_step(
            self.params, self.cache, self._tok_state, self._gen_dev, self._eos_dev,
            sampler=self.sampler,
        )
        self._tok_state = toks
        self.stats.decode_steps += 1
        self.stats.engine_steps += 1
        reqs = {}
        for i in active:
            req = self.slots[i]
            req.in_flight += 1
            reqs[i] = req
        self._dispatch(_PendingStep(step=self.stats.engine_steps, reqs=reqs,
                                    fetch=_Fetch(toks, eos)))
        return True

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if not self.step():
                break
        if self.async_mode:
            self._drain()           # settle out_tokens if max_steps truncated
        return self.stats

    def kv_bytes(self) -> int:
        """Physical KV footprint of the resident cache."""
        return kv_cache.kv_bytes(self.cache)
