"""Continuous-batching serving engine: dense or paged KV cache, decode-only
or hybrid schedule, synchronous or dispatch-ahead.

Counterpart of ``repro.serving.engine`` for ``cache_kind`` in {"dense",
"paged"} (bf16, fp8 or int8 pool, with or without the host tier) and
``schedule`` in {"decode-only", "hybrid"}, in both execution modes, with
or without speculative decoding, traced and profiled or not, as a
replica of a :class:`~repro_torch.serving.cluster.Cluster` (router hooks,
KV block migration, refold moves) or alone, and on the dense
decode-only schedule with sub-batch pipelining (``sub_batches``).

Slot-based continuous batching (Orca-style): a fixed decode batch of
``n_slots`` sequences; a finished sequence frees its slot and the next
queued request is prefilled into it while the others keep decoding.

* ``cache_kind="dense"`` — every slot owns a ``max_seq`` stripe; a
  released slot is zeroed.  Decode-only admission writes the prompt's
  K/V straight into the slot's stripe (a view), after zeroing it — the
  contents the reference gets by prefilling a fresh batch-1 cache and
  copying the whole stripe in.
* ``cache_kind="paged"`` — physical KV is a pool of fixed-size blocks
  (:class:`~repro_torch.serving.paged.BlockPool`); admission waits on
  free blocks, shared prompt prefixes share blocks (copy-on-write on the
  first divergent append), and a dry pool preempts the youngest sequence
  back to the queue, to be re-prefilled from prompt plus generated
  tokens (greedy-exact).  ``kv_dtype="fp8"|"int8"`` stores the pool
  quantized (the staging cache stays full precision).  ``host_blocks >
  0`` adds a host tier: freed prefix blocks spill there and re-hydrate
  as cache hits, and a dry pool first spills the oldest sequence's cold
  prefix blocks (spill-before-evict) — that sequence keeps decoding over
  its hot and cold windows, merged by log-sum-exp.
* ``schedule="hybrid"`` — the token-budget :class:`Scheduler` packs each
  step as one decode token per active slot plus one chunk of the
  head-of-queue prompt, padded to ``prefill_chunk`` (two at a prompt
  boundary: Sarathi-SC boundary packing).  The reference's
  fused/solo/fused2/solo2 jit programs are :meth:`Engine._dispatch_body`:
  the chunk(s) first, then the decode batch, the same calls in the same
  order.  The paged cache stages chunks in a two-lane dense staging
  cache and flushes completed blocks into the pool.

* ``async_mode=False`` — synchronous: every decode step's logits come
  back to the host and are sampled there (:func:`sampler.sample`).
* ``async_mode=True`` (default) — dispatch-ahead: each step samples on
  the device and feeds its ``(B,)`` token ids to the next step through
  the device-resident ``tok_state``.  CUDA stream order takes the place
  of JAX's data-flow ordering: step *t+1* is enqueued before step *t*'s
  ids are read, those ids travel by a non-blocking copy into pinned
  memory with a CUDA event (waited on only after *t+1* is in flight), and
  host bookkeeping issued at dispatch (table rows, block copies, slot
  resets) lands after the in-flight step.  Length and max-new
  retirements are known at dispatch; EOS is seen one step late and the
  token dispatched past it is masked.  A preemption observes only the
  victim's in-flight tokens first; greedy output is token-identical to
  sync mode.

* ``spec_depth=k > 0`` — speculative decoding: each decode dispatch runs
  k draft decode+sample passes and one more draft decode on the draft's
  own dense cache, the target's (k+1)-position verify, rejection sampling
  and both length commits (:meth:`Engine._spec_core`), all on the device;
  the emitted ``(B, k+1)`` rows and acceptance counts reach the host with
  the pipeline.  It always runs on the dispatch-ahead machinery;
  ``async_mode=False`` observes each dispatch right after it.  Every slot
  of a window carries ``k+1`` in-flight charges, refunded as the window is
  observed; an EOS inside an accepted window truncates the rest.  Greedy
  output is token-identical to plain decoding.

Every dispatch kind (``decode``, ``fused``, ``solo``, ``fused2``,
``solo2``, ``spec``, ``spec_fused``) and the draft's chunk prefill is one
:class:`~repro_torch.serving.programs.Program`, the counterpart of the
reference's ``jax.jit`` programs: with ``graphs`` (the default on a CUDA
device) it is captured as one CUDA graph at its first dispatch and
replayed after one host-to-device copy of the step's scalars; on the CPU,
or with ``graphs=False``, the same body runs eagerly through the same
buffers.  The host's bookkeeping (block tables, block copies, spills,
slot resets, the whole-prompt prefill of decode-only admission) stays
outside the graphs, in stream order around the replays.

* ``sub_batches=n > 1`` (dense cache, decode-only schedule, no
  speculation, as in the reference) — the decode step runs as ``n``
  sub-batches against views of the cache (:func:`core.pipeline.pipelined_step`),
  each on its own CUDA stream forked from the engine's and joined back,
  inside the captured program: the ``decode`` graph holds ``n`` parallel
  branches.  On the CPU they run one after another.  Async mode samples
  the concatenated logits, as the reference's ``_wrap_sampled`` does.

Cross-replica migration (disaggregated serving): :meth:`Engine.preview_export`
sizes a move without side effects, :meth:`Engine.export_request` detaches
a resident request with its KV (the paged pool's blocks gathered in
storage dtype, scale pools included; the dense cache's stripe), and
:meth:`Engine.can_import` / :meth:`Engine.import_request` land it on
another replica, writing into that engine's tensors in place (the
captured programs read them), deduped against the destination's prefix
cache.  The cluster drives this; a declined export decodes in place.

Step accounting (``EngineStats.engine_steps``) matches the reference: a
model dispatch is one step, a decode-only whole prefill of ``L`` tokens
costs ``ceil(L / prefill_chunk)`` steps.

Telemetry (``serving/telemetry``): the engine calls the reference
engine's tracer hooks at the same points of the same step functions, so
on the CPU a traced run gives the reference's spans, events and
:class:`StepRecord` timeline.  A :class:`DispatchProfiler` fences a
sample of dispatches on the device; under CUDA graphs the dispatch that
captures its kind's graph is not counted (see the profiler).  With the
defaults (``NULL_TRACER``, ``NULL_PROFILER``) no record is built.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.pipeline import pipelined_step
from repro_torch.models.registry import Model
from repro_torch.serving import kv_cache
from repro_torch.serving.paged import BlockPool, PagedCacheManager
from repro_torch.serving.paged import device as paged_dev
from repro_torch.serving.programs import Program
from repro_torch.serving.sampler import (SamplerConfig, sample, sample_on_device,
                                         spec_draft_sample, spec_verify_tokens)
from repro_torch.serving.scheduler import PrefillChunk, Scheduler
from repro_torch.serving.telemetry import (NULL_PROFILER, NULL_TRACER, DispatchCostModel,
                                           StepRecord, percentile)
from repro_torch.serving.telemetry.timeline import chunk_bucket

Pytree = Any


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
    # async bookkeeping: token charges and steps dispatched but not yet
    # observed (equal without speculation; k+1 charges per window with it)
    in_flight: int = 0
    in_flight_steps: int = 0
    admit_base: int = 0             # len(out_tokens) at last (re-)admission


@dataclasses.dataclass
class EngineStats:
    """Field for field the reference's ``EngineStats``."""

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


@dataclasses.dataclass
class EngineLoad:
    """One replica's load snapshot, read by the cluster router.

    ``inflight_tokens`` counts KV positions committed to this replica —
    prompt plus generated (observed and dispatched) tokens of every
    resident request, plus the prompt tokens of anything waiting in the
    local queue (a preempted request is still this replica's work).
    """

    free_slots: int
    queued: int
    inflight_tokens: int
    free_blocks: int | None         # paged only; None for the dense cache


@dataclasses.dataclass
class MigrationTicket:
    """Host-side description of an exported resident request's KV.

    ``keys`` is the paged hash-key chain aligned with the payload's block
    columns (None entries are diverged tails / decode headroom); the dense
    cache has no keys (``None``) and its payload is a batch-1 sub-cache.
    ``length`` is the KV positions held (prompt + observed output - 1: the
    last sampled token is the next step's *input*).
    """

    length: int
    kv_dtype: str
    keys: list | None = None         # paged: per-block hash chain
    n_blocks: int = 0                # paged: payload block count
    block_size: int = 0              # paged: source pool block granularity
    src_step: int = 0                # source engine-step clock at export


class _Fetch:
    """Small device tensors on their way to the host.  On CUDA: a
    non-blocking copy into pinned memory plus an event, enqueued in
    stream order (so later in-place writes to the tensors do not reach
    it); :meth:`numpy` waits on that event only."""

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


class _Dispatch(NamedTuple):
    """What :meth:`Engine._exec` ran: the kind, whether the profiler
    fenced it, and whether it captured its kind's CUDA graph."""

    kind: str
    sampled: bool
    captured: bool


@dataclasses.dataclass
class _PendingStep:
    """One dispatched-but-unobserved step.  ``reqs`` pins the requests in
    the decode batch at dispatch (a slot may be re-admitted to another
    request before the step is observed)."""

    step: int                            # engine_steps value at dispatch
    reqs: dict[int, Request]             # slot -> request in decode batch
    fetch: _Fetch | None                 # (B,) sampled ids, (B,) EOS hits;
                                         # spec: (B, k+1) emitted, (B,) n_accept
    work: PrefillChunk | None = None     # chunk fused into this step
    pre: _Fetch | None = None            # (1,) its first token when work.last
    work2: PrefillChunk | None = None    # boundary-packed second chunk
    pre2: _Fetch | None = None
    spec: bool = False                   # a speculative window
    charge: int = 1                      # in-flight charges per batch slot


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
        block_size: int = 16,
        n_blocks: int | None = None,
        kv_dtype: str = "bf16",
        host_blocks: int = 0,
        schedule: str = "decode-only",
        prefill_chunk: int = 32,
        token_budget: int | None = None,
        async_mode: bool = True,
        spec_depth: int = 0,
        draft_model: Model | None = None,
        draft_params: Pytree | None = None,
        graphs: bool | None = None,
        tracer=None,
        profiler=None,
        replica: int = 0,
        role: str = "mixed",
    ):
        # speculation always runs on the dispatch-ahead machinery; sync mode
        # is that pipeline at depth zero (observe right after dispatch)
        if spec_depth < 0:
            raise ValueError(f"spec_depth must be >= 0, got {spec_depth}")
        self.spec_depth = spec_depth
        self.draft_model = draft_model
        self.draft_params = draft_params
        self._sync_pipeline = False
        if spec_depth:
            self._check_spec(model, draft_model, draft_params, sub_batches, cache_kind,
                             kv_dtype, host_blocks)
            self._sync_pipeline = not async_mode
            async_mode = True
        # the role is advisory routing metadata (the cluster admits prompts
        # to prefill/mixed replicas and migrates finished prefills off
        # "prefill" ones); the engine handles both phases, so a migration
        # that finds no destination decodes in place
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown role {role!r}")
        self.role = role
        if cache_kind != "paged" and (kv_dtype != "bf16" or host_blocks):
            raise ValueError("kv_dtype / host_blocks are paged-cache features "
                             f"(cache_kind={cache_kind!r})")
        if cache_kind == "paged" and sub_batches != 1:
            raise NotImplementedError(
                "paged cache does not compose with sub-batch pipelining yet")
        if cache_kind not in ("dense", "paged"):
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        if schedule == "hybrid" and sub_batches != 1:
            raise NotImplementedError(
                "hybrid schedule does not compose with sub-batch pipelining yet")
        self.sub_batches = sub_batches
        self.model = model
        self.params = params
        self.device = model.device
        self.max_seq = max_seq
        self.sampler = sampler
        self.cache_kind = cache_kind
        self.kv_dtype = kv_dtype
        self.host_blocks = host_blocks
        self.schedule = schedule
        self.prefill_chunk = prefill_chunk
        self.async_mode = async_mode
        self.slots: list[Request | None] = [None] * n_slots
        self.stats = EngineStats()
        # telemetry: NULL_TRACER / NULL_PROFILER hooks are no-ops, and
        # `_telemetry` gates building the per-dispatch StepRecord, so a
        # disabled run does no extra host work
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.profiler = NULL_PROFILER if profiler is None else profiler
        self._telemetry = self.tracer.enabled or self.profiler.enabled
        self.replica = replica
        self._cost_model = DispatchCostModel(model.cfg) if self._telemetry else None
        # kind -> engine step of the dispatch that captured its CUDA graph
        self.capture_steps: dict[str, int] = {}
        # explicit generators: one on the device for the fused sampler,
        # one on the host for the synchronous oracle sampler
        self._gen_dev = torch.Generator(device=self.device).manual_seed(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        # one program per dispatch kind (serving/programs.py), captured as
        # a CUDA graph on a CUDA device unless graphs=False; eager on the CPU
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not {self.device}")
        self.programs: dict[str, Program] = {}
        if self.graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._side_stream = torch.cuda.Stream(self.device)
        if cache_kind == "paged":
            self.block_size = block_size
            self.max_blocks = -(-max_seq // block_size)
            # default: the dense cache's physical budget, + the null block
            self.n_blocks = n_slots * self.max_blocks + 1 if n_blocks is None else n_blocks
            if self.n_blocks - 1 < self.max_blocks:
                raise ValueError(
                    f"pool of {self.n_blocks - 1} usable blocks cannot hold one "
                    f"max_seq={max_seq} sequence ({self.max_blocks} blocks)")
            self.pool = BlockPool(self.n_blocks, block_size, host_blocks=host_blocks)
            self.manager = PagedCacheManager(self.pool, n_slots, self.max_blocks)
            self.cache = model.init_paged_cache(n_slots, self.n_blocks, block_size,
                                                self.max_blocks, kv_dtype=kv_dtype,
                                                host_blocks=host_blocks)
            self._decode = model.paged_decode_step
            self._decode_sampled = model.paged_decode_sample_step
        else:
            self.cache = model.init_cache(n_slots, max_seq)
            self._decode = model.decode_step
            self._decode_sampled = model.decode_sample_step
            if sub_batches != 1:
                # one stream per sub-batch on the card, created before any
                # capture; the CPU runs the sub-batches in order
                streams = ([torch.cuda.Stream(self.device) for _ in range(sub_batches)]
                           if self.device.type == "cuda" else None)
                self._decode = pipelined_step(model.decode_step, sub_batches, streams)
                self._decode_sampled = self._wrap_sampled(self._decode)
        self._pending: deque[_PendingStep] = deque()
        self._first_pending: list[tuple[Request, _Fetch]] = []
        if async_mode:
            self._tok_state = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
            self._eos_dev = torch.full((n_slots,), -1, dtype=torch.int32,
                                       device=self.device)
        self.sched = Scheduler(
            n_slots=n_slots, max_seq=max_seq, mode=schedule,
            prefill_chunk=prefill_chunk, token_budget=token_budget,
            block_size=block_size if cache_kind == "paged" else None,
            spec_width=spec_depth + 1,
        )
        # dispatches by kind, the reference's jit programs: "decode",
        # "fused", "solo", "fused2", "solo2", "spec", "spec_fused"
        self.dispatch_counts: collections.Counter[str] = collections.Counter()
        if schedule == "hybrid":
            # per-slot chunked-prefill state (set by _begin_prefill): the
            # pinned token stream, prefix-cache-hit block count and (paged)
            # the staging lane — boundary packing keeps two prompts
            # mid-flight for one dispatch
            self._pf_tokens: dict[int, np.ndarray] = {}
            self._pf_prefix: dict[int, int] = {}
            self._pf_lane: dict[int, int] = {}
            if cache_kind == "paged":
                # persistent two-lane staging cache: chunks accumulate here
                # and completed blocks flush into the pool
                self.staging = model.init_cache(2, self.max_blocks * block_size)
        if spec_depth:
            # the draft's cache is always dense (the draft is small), its
            # lengths mirroring the target's committed lengths slot for slot
            self.d_cache = draft_model.init_cache(n_slots, max_seq)
            self._verify = (model.paged_verify_step if cache_kind == "paged"
                            else model.verify_step)

    @staticmethod
    def _wrap_sampled(base_step):
        """Fuse on-device sampling onto a logits step (the sub-batch
        pipelined step has no sampled form of its own)."""

        def sampled(params, cache, tokens, generator, eos_ids, *, sampler):
            logits, cache = base_step(params, cache, tokens)
            tok = sample_on_device(logits, generator, sampler)
            return tok, tok == eos_ids, cache

        return sampled

    @staticmethod
    def _check_spec(model, draft_model, draft_params, sub_batches, cache_kind, kv_dtype,
                    host_blocks) -> None:
        """The reference's refusals of a speculative engine, in its order
        and with its exception types."""
        if draft_model is None or draft_params is None:
            raise ValueError("spec_depth > 0 needs a draft_model and draft_params")
        if sub_batches != 1:
            raise NotImplementedError(
                "speculative decoding does not compose with sub-batch pipelining yet")
        if model.cfg.kv_quant:
            raise NotImplementedError("speculative decoding does not support kv_quant yet")
        if (model.paged_verify_step if cache_kind == "paged" else model.verify_step) is None:
            raise ValueError(f"{model.cfg.family} has no verify_step: speculative decoding "
                             "needs the multi-position scoring entry point")
        if draft_model.prefill_step is None:
            raise ValueError(f"draft family {draft_model.cfg.family} has no prefill_step: "
                             "the draft cache is filled chunk-wise")
        if draft_model.cfg.vocab != model.cfg.vocab:
            raise ValueError(f"draft vocab {draft_model.cfg.vocab} != target vocab "
                             f"{model.cfg.vocab}: rejection sampling needs one token space")
        if cache_kind == "paged" and (kv_dtype != "bf16" or host_blocks):
            raise NotImplementedError(
                "speculative verification reads the bf16 device pool only (no quantized "
                "kv_dtype / host tier yet)")

    # ------------------------------------------------- speculative decoding
    def _spec_core(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One speculative window, all on the device: k draft decode+sample
        passes, one more draft decode (so that a fully accepted window
        leaves the draft cache holding the last draft's K/V too), the
        target's (k+1)-position verify, rejection sampling, and both length
        commits.  The token at ``n_accept`` of each row becomes the next
        ``tok_state``.  The calls run in the reference program's order,
        which stream order keeps.  Returns ``(emitted (B, k+1), n_accept
        (B,))``."""
        k, draft, gen = self.spec_depth, self.draft_model, self._gen_dev
        tok = self._tok_state
        drafts, probs = [], []
        for _ in range(k):
            d_logits, _ = draft.decode_step(self.draft_params, self.d_cache, tok)
            tok, p = spec_draft_sample(d_logits, gen, self.sampler)
            drafts.append(tok)
            if p is not None:
                probs.append(p)
        draft.decode_step(self.draft_params, self.d_cache, tok)
        tokens = torch.stack([self._tok_state] + drafts, dim=1)       # (B, k+1)
        v_logits, _ = self._verify(self.params, self.cache, tokens)
        emitted, n_accept = spec_verify_tokens(
            v_logits, torch.stack(drafts, dim=1), torch.stack(probs, dim=1) if probs else None,
            gen, self.sampler)
        # the commit is the rollback: lengths advance over the accepted
        # prefix and the bonus token only; the draft's k+1 decodes net back
        # to the same commit
        self.cache["lengths"].add_(n_accept + 1)
        self.d_cache["lengths"].add_(n_accept - k)
        self._tok_state.copy_(emitted[torch.arange(emitted.shape[0], device=emitted.device),
                                      n_accept.long()])
        return emitted, n_accept

    def _draft_prefill_slot(self, slot: int, tokens: np.ndarray) -> None:
        """Prefill ``tokens`` into the draft cache at ``slot``, in chunks of
        ``prefill_chunk``, through the ``draft_prefill`` program, so that
        draft and target lengths agree at the slot's next dispatch.  Issued
        at dispatch time: stream order puts it after every in-flight step's
        draft writes."""
        if not self.spec_depth:
            return
        chunk = self.prefill_chunk
        prog = self._program("draft_prefill")
        for start in range(0, len(tokens), chunk):
            nv = min(chunk, len(tokens) - start)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :nv] = tokens[start:start + nv]
            prog(tok0=buf, chunk0=(slot, 0, start, nv, 1))
            self.stats.draft_steps += 1

    # ------------------------------------------------- one program per kind
    # kind -> (prefill chunks, runs the decode batch): the reference's jit
    # programs, which Engine._dispatch_kind names
    KINDS = {"decode": (0, True), "spec": (0, True), "fused": (1, True),
             "spec_fused": (1, True), "solo": (1, False), "fused2": (2, True),
             "solo2": (2, False), "draft_prefill": (1, False)}

    def _program(self, kind: str) -> Program:
        """The program of dispatch ``kind``, built at its first use.  Its
        inputs: the decode batch's tokens (sync mode; async mode feeds the
        device-resident ``tok_state``), and per chunk its padded tokens and
        the scalars ``(slot, lane, start, n_valid, last)``."""
        prog = self.programs.get(kind)
        if prog is not None:
            return prog
        n_chunks, decode = self.KINDS[kind]
        inputs = {}
        if decode and not self.async_mode:
            inputs["tokens"] = (len(self.slots),)
        for i in range(n_chunks):
            inputs[f"tok{i}"] = (1, self.prefill_chunk)
            inputs[f"chunk{i}"] = (5,)
        # the body holds its engine weakly: an engine <-> program cycle
        # would leave a dead engine's graphs to the cyclic collector, which
        # may run inside another engine's capture, where freeing a graph is
        # not allowed
        eng = weakref.ref(self)
        if kind == "draft_prefill":
            def body(inp):
                return eng()._draft_prefill_body(inp)
        else:
            def body(inp, n_chunks=n_chunks, decode=decode):
                return eng()._dispatch_body(inp, n_chunks, decode)
        graph_kw = {}
        if self.graphs:
            graph_kw = dict(graphs=True, pool=self._graph_pool, stream=self._side_stream,
                            generators=(self._gen_dev,))
        prog = self.programs[kind] = Program(kind, body, inputs, self.device, **graph_kw)
        return prog

    def _dispatch_body(self, inp, n_chunks: int, decode: bool) -> tuple[torch.Tensor, ...]:
        """The body of a dispatch kind (the reference's ``fused`` / ``solo``
        / ``fused2`` / ``solo2`` / ``spec_fused`` programs and the decode
        and ``spec`` steps): the chunk(s) first, then the decode batch,
        the same calls in the same order.  Sync mode returns the decode
        logits (if any), then each chunk's logits.  Async mode returns the
        decode batch's ``(ids (B,), EOS hits (B,))`` or speculative
        ``(emitted (B, k+1), n_accept (B,))`` (if any), then each chunk's
        sampled first token; a chunk whose ``last`` scalar is set splices
        its token into ``tok_state`` (the reference's ``jnp.where(last,
        ...)``), after the decode batch wrote its ids there."""
        scalars = [inp[f"chunk{i}"] for i in range(n_chunks)]
        logits = [self._run_chunk(inp[f"tok{i}"], scalars[i]) for i in range(n_chunks)]
        out: tuple[torch.Tensor, ...] = ()
        if decode:
            out = self._decode_body(inp)
            self._hold_lengths(scalars)
        if not self.async_mode:
            return (*out, *logits)
        pre = tuple(sample_on_device(lg, self._gen_dev, self.sampler) for lg in logits)
        for sc, tok in zip(scalars, pre):
            paged_dev.feed_token(self._tok_state, sc[0:1], tok, when=sc[4:5])
        return (*out, *pre)

    def _decode_body(self, inp) -> tuple[torch.Tensor, ...]:
        """The decode batch: logits from the host's tokens (sync), or
        sampled on the device from ``tok_state``, written back in place (a
        speculative window, or one token per slot)."""
        if not self.async_mode:
            logits, _ = self._decode(self.params, self.cache, inp["tokens"])
            return (logits,)
        if self.spec_depth:
            return self._spec_core()
        toks, eos, _ = self._decode_sampled(
            self.params, self.cache, self._tok_state, self._gen_dev, self._eos_dev,
            sampler=self.sampler)
        self._tok_state.copy_(toks)
        return toks, eos

    def _draft_prefill_body(self, inp) -> tuple[torch.Tensor, ...]:
        sc = inp["chunk0"]
        self.draft_model.prefill_step(self.draft_params, self.d_cache, inp["tok0"], sc[0:1],
                                      sc[2:3], sc[3:4])
        return ()

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
        self.tracer.on_submit(self.replica, req, req.submit_step)

    # ------------------------------------------------- cluster router hooks
    def load(self) -> EngineLoad:
        """Load snapshot for ``least_loaded`` routing (read-only).  A
        chunked prefill in flight (``sched.inflight``) is committed work on
        a reserved slot even though the request is in neither ``slots`` nor
        the queue yet: both count."""
        inflight = sum(len(r.prompt) + len(r.out_tokens) + r.in_flight
                       for r in self.slots if r is not None)
        inflight += sum(len(r.prompt) + len(r.out_tokens) for r in self.sched.queue)
        fl = self.sched.inflight
        if fl is not None:
            inflight += fl.total
        return EngineLoad(
            free_slots=self.slots.count(None) - (0 if fl is None else 1),
            queued=len(self.sched),
            inflight_tokens=inflight,
            free_blocks=self.pool.free_count if self.cache_kind == "paged" else None,
        )

    def _admit_tokens(self, req: Request) -> np.ndarray:
        """What admitting ``req`` prefills: a preempted request's generated
        tokens are folded in, so the block bill covers prompt + output."""
        return self._refold(req) if req.out_tokens else np.asarray(req.prompt, np.int32)

    def can_admit(self, req: Request) -> bool:
        """Would ``req`` be this replica's *next* prefill?  The router's
        spill-over probe: read-only and conservative (counts resident prefix
        hits, never blocks a preemption could free).  A chunked prefill in
        flight counts as running (its slot is subtracted); any locally
        *queued* request means an unbounded wait, so the answer is no."""
        fl = self.sched.inflight
        free = self.slots.count(None) - (0 if fl is None else 1)
        if len(self.sched) or free < 1:
            return False
        if self.cache_kind != "paged":
            return True
        return self.manager.admit_shortfall(self._admit_tokens(req)) <= self.pool.free_count

    def probe_prefix(self, prompt: np.ndarray) -> int:
        """Longest resident prompt prefix, in tokens (0 for the dense cache,
        which has no prefix reuse).  Side-effect free: the router's
        ``prefix_affinity`` score."""
        if self.cache_kind != "paged":
            return 0
        return self.manager.probe_prefix(np.asarray(prompt, np.int32))

    # ---------------------------------------------------- KV block migration
    def export_request(self, slot: int):
        """Detach the resident request on ``slot``, with its KV, for
        migration to a peer replica.

        Async mode observes the victim's in-flight tokens first
        (:meth:`_observe_victim`) so that the exported history is exact;
        that may reveal the request already finished.  Then, or when the
        slot holds a cold host-tier prefix (only fully device-resident
        sequences migrate), the export is declined and ``None`` returned.

        Otherwise returns ``(req, ticket, payload)``: the request (its slot
        here is freed), a :class:`MigrationTicket` and the storage-dtype KV
        payload (:func:`paged.device.copy_blocks_out` /
        :func:`kv_cache.export_slot`), gathered in stream order after every
        step already issued.  Shared-prefix blocks are copied out: this
        replica's remaining owners keep the block and its hash entry, and a
        dying private registered prefix still spills to the host tier."""
        req = self.slots[slot]
        if req is None or req.done:
            return None
        if self.async_mode:
            self._observe_victim(slot)
            req = self.slots[slot]
            if req is None or req.done:
                return None             # finished while observing
        if self.cache_kind == "paged" and self.manager.cold_blocks[slot]:
            return None
        length = len(req.prompt) + len(req.out_tokens) - 1
        if self.cache_kind == "paged":
            ids = list(self.manager.blocks[slot])
            payload = paged_dev.copy_blocks_out(self.cache, ids)
            _, keys = self.manager.export_slot(slot)
            # dying private prefixes may spill host-ward: copy them before
            # the freed device blocks can be reallocated and rewritten
            self._apply_pool_directives()
            paged_dev.sync_slot(self.cache, slot, self.manager.tables[slot], 0)
            ticket = MigrationTicket(length=length, kv_dtype=self.kv_dtype, keys=keys,
                                     n_blocks=len(ids), block_size=self.block_size,
                                     src_step=self.stats.engine_steps)
        else:
            payload = kv_cache.export_slot(self.cache, slot)
            kv_cache.reset_slot(self.cache, slot)
            ticket = MigrationTicket(length=length, kv_dtype=self.kv_dtype,
                                     src_step=self.stats.engine_steps)
        self.slots[slot] = None
        self.stats.migrations_out += 1
        return req, ticket, payload

    def preview_export(self, slot: int) -> MigrationTicket | None:
        """Read-only ticket for what :meth:`export_request` would produce,
        so that the cluster probes destinations (:meth:`can_import`) before
        paying the export.  Exact: the manager's block and key lists already
        reflect every dispatched append, and observing the victim's
        in-flight tokens only turns them into observed output (same KV
        length) or finishes the request (the export declines).  None when
        the slot is empty, done, or holds a cold host-tier prefix."""
        req = self.slots[slot]
        if req is None or req.done:
            return None
        length = len(req.prompt) + len(req.out_tokens) + req.in_flight - 1
        if self.cache_kind != "paged":
            return MigrationTicket(length=length, kv_dtype=self.kv_dtype,
                                   src_step=self.stats.engine_steps)
        if self.manager.cold_blocks[slot]:
            return None
        return MigrationTicket(length=length, kv_dtype=self.kv_dtype,
                               keys=list(self.manager.keys[slot]),
                               n_blocks=len(self.manager.blocks[slot]),
                               block_size=self.block_size, src_step=self.stats.engine_steps)

    def can_import(self, ticket: MigrationTicket) -> bool:
        """Read-only: could :meth:`import_request` land ``ticket`` now
        without touching anyone?  Conservative: the import may also free
        blocks by spilling when a host tier exists, but it never preempts."""
        if ticket.kv_dtype != self.kv_dtype or ticket.length >= self.max_seq - 1:
            return False
        if (ticket.keys is None) != (self.cache_kind != "paged"):
            return False
        if not self._free_slots():
            return False
        if self.cache_kind != "paged":
            return True
        if ticket.block_size != self.block_size:
            return False
        return self.manager.import_shortfall(ticket.keys, ticket.length) <= self.pool.free_count

    def import_request(self, req: Request, ticket: MigrationTicket, payload) -> int | None:
        """Land a migrating request: allocate or dedup its blocks, scatter
        the payload columns the local prefix cache does not hold, and resume
        decode with the same next-input token over the same KV (greedy
        output is token-identical to never having migrated).  Every write
        goes into this engine's tensors in place: the captured programs
        read them.  Under block pressure with a host tier, resident cold
        prefixes spill (spill-before-evict); nobody is preempted.  Returns
        the landing slot, or ``None``, with nothing changed, when capacity
        cannot be found."""
        if ticket.kv_dtype != self.kv_dtype:
            return None
        free = self._free_slots()
        if not free:
            return None
        slot = free[0]
        if self.cache_kind == "paged":
            fresh = self.manager.import_shortfall(ticket.keys, ticket.length)
            if fresh > self.pool.free_count:
                if not self.pool.host_blocks:
                    return None
                alive = [i for i, s in enumerate(self.slots) if s is not None]
                while fresh > self.pool.free_count and self._try_spill(alive):
                    pass
                if fresh > self.pool.free_count:
                    return None
            res = self.manager.import_slot(slot, ticket.keys, ticket.length)
            if res is None:
                return None
            ids, needs = res
            # only the columns the local prefix cache lacks (a trailing
            # headroom block has no payload column)
            sel = [j for j in range(ticket.n_blocks) if needs[j]]
            if sel:
                paged_dev.copy_blocks_in(self.cache, self._localize(payload), sel,
                                         [ids[j] for j in sel])
            paged_dev.sync_slot(self.cache, slot, self.manager.tables[slot], ticket.length)
        else:
            kv_cache.insert(self.cache, self._localize(payload), slot)
        self.slots[slot] = req
        # carry decode-latency accounting onto this engine's step clock
        if req.first_token_step >= 0:
            req.first_token_step = (
                self.stats.engine_steps - (ticket.src_step - req.first_token_step))
        if self.async_mode:
            # the last sampled token is the next decode input, as on the source
            paged_dev.feed_token(self._tok_state, slot, int(req.out_tokens[-1]))
            paged_dev.set_stop_id(self._eos_dev, slot, req.eos_id)
            # the draft cache did not travel: rebuild it from the history
            # (all but the next input, the target's imported KV length)
            self._draft_prefill_slot(slot, self._refold(req)[:-1])
        self.stats.migrations_in += 1
        return slot

    def _localize(self, payload: Pytree) -> Pytree:
        """A migration payload on this engine's device: the same tensors
        when source and destination share the card, else a copy."""
        return {k: v.to(self.device) for k, v in payload.items()}

    # ---------------------------------------------- cluster refold leveling
    def can_admit_next(self) -> bool:
        """Will this engine's *own* queue head be admittable at the next
        step?  (:meth:`can_admit` answers for a foreign request and says no
        whenever anything is queued here; this is the home replica's
        mirror, consulted before a preempted request's refold moves.)"""
        if not len(self.sched):
            return False
        fl = self.sched.inflight
        if self.slots.count(None) - (0 if fl is None else 1) < 1:
            return False
        if self.cache_kind != "paged":
            return True
        head = self.sched.queue[0]
        return self.manager.admit_shortfall(self._admit_tokens(head)) <= self.pool.free_count

    def take_refold(self) -> Request | None:
        """Pop this engine's queue head if it is a preempted (refolding)
        request the cluster wants to place elsewhere; None otherwise."""
        q = self.sched.queue
        if q and q[0].out_tokens and not q[0].done:
            return self.sched.pop()
        return None

    def adopt_refold(self, req: Request) -> None:
        """Accept a refolding request moved from another replica: it keeps
        queue-front priority and re-enters on this engine's step clock."""
        req.submit_step = self.stats.engine_steps
        self.sched.push_front(req)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @staticmethod
    def _refold(req: Request) -> np.ndarray:
        """Prompt plus already-generated tokens: prefilling this exactly
        reproduces a preempted request's decode state (greedy-exact)."""
        assert req.in_flight == 0 and req.in_flight_steps == 0, (
            "refold needs every dispatched token observed")
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.out_tokens, np.int32)])

    # --------------------------------------------- async pipeline primitives
    def _predicted_done(self, req: Request) -> bool:
        """Will the sync engine have marked ``req`` done once every
        dispatched token is observed?  The first token after a
        (re-)admission comes from the prefill and is never length-checked."""
        c = len(req.out_tokens) + req.in_flight_steps
        if c < req.admit_base + 2:
            return False
        return c >= req.max_new_tokens or len(req.prompt) + c >= self.max_seq - 1

    def _predicted_active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not self._predicted_done(s)]

    def _dispatch(self, rec: _PendingStep) -> None:
        """Queue a dispatched step; observe the previous one only after
        the new one is in flight (a sync-mode speculative engine observes
        it at once)."""
        self._pending.append(rec)
        if self._sync_pipeline:
            self._drain()
            return
        if len(self._pending) > 1:
            self._observe(self._pending.popleft())

    @staticmethod
    def _take_first(req: Request, fetch: _Fetch) -> None:
        req.in_flight -= 1
        req.in_flight_steps -= 1
        req.out_tokens.append(int(fetch.numpy()[0][0]))

    def _flush_first(self) -> None:
        for req, fetch in self._first_pending:
            self._take_first(req, fetch)
        self._first_pending.clear()

    def _take_decode(self, slot: int, req: Request, rec: _PendingStep) -> int:
        """Apply one observed decode token (or speculative window) of
        ``req`` from ``rec``; a token dispatched past an EOS (``req.done``)
        is masked.  Returns the drafts accepted (0 without speculation)."""
        req.in_flight -= rec.charge
        req.in_flight_steps -= 1
        if req.done:
            return 0
        if rec.spec:
            return self._take_spec(slot, req, rec)
        toks, eos = rec.fetch.numpy()
        req.out_tokens.append(int(toks[slot]))
        self.stats.generated += 1
        length = len(req.prompt) + len(req.out_tokens)
        if (bool(eos[slot]) or len(req.out_tokens) >= req.max_new_tokens
                or length >= self.max_seq - 1):
            self._finish(slot, req, rec.step)
        return 0

    def _take_spec(self, slot: int, req: Request, rec: _PendingStep) -> int:
        """Commit one slot's observed window: the accepted drafts and the
        bonus or correction token, in stream order, with the sync engine's
        finish checks after each (an EOS inside the window truncates the
        rest), as if ``n_accept + 1`` plain steps had been observed.
        Returns the drafts accepted."""
        emitted, n_accept = rec.fetch.numpy()
        n_emit = int(n_accept[slot]) + 1
        self.stats.drafted_tokens += self.spec_depth
        self.stats.accepted_tokens += n_emit - 1
        self.stats.spec_accept_samples.append((n_emit - 1) / self.spec_depth)
        for t in range(n_emit):
            tok = int(emitted[slot, t])
            req.out_tokens.append(tok)
            self.stats.generated += 1
            length = len(req.prompt) + len(req.out_tokens)
            if (tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens
                    or length >= self.max_seq - 1):
                self._finish(slot, req, rec.step)
                break
        return n_emit - 1

    def _observe(self, rec: _PendingStep) -> None:
        """Read one step's ids and EOS flags and apply completions."""
        self._flush_first()
        for work, pre in ((rec.work, rec.pre), (rec.work2, rec.pre2)):
            if work is not None and work.last:
                self._take_first(work.req, pre)
        if rec.fetch is None:
            return
        accepted = 0
        for i, req in rec.reqs.items():
            accepted += self._take_decode(i, req, rec)
        if rec.spec and self.tracer.enabled:
            # stamped at the window's dispatch step, as spec_propose is
            self.tracer.on_spec_verify(self.replica, rec.step, accepted, len(rec.reqs))

    def _drain(self) -> None:
        """Observe every in-flight step (``out_tokens`` become exact)."""
        while self._pending:
            self._observe(self._pending.popleft())
        self._flush_first()

    def _observe_victim(self, slot: int) -> None:
        """Observe only ``slot``'s in-flight tokens, in dispatch order,
        leaving every other slot's in flight: the preemption refold needs
        one slot's exact history.  The victim's entries are consumed out of
        each record so a later :meth:`_observe` skips them.  No-op when
        nothing of the victim's is in flight (sync mode always)."""
        req = self.slots[slot]
        if req is None or req.in_flight == 0:
            return
        self.stats.victim_drains += 1
        kept = []
        for r, fetch in self._first_pending:
            if r is req:
                self._take_first(r, fetch)
            else:
                kept.append((r, fetch))
        self._first_pending[:] = kept
        for rec in self._pending:
            if rec.work is not None and rec.work.last and rec.work.req is req:
                self._take_first(req, rec.pre)
                rec.work = None          # consumed; _observe must not re-apply
            if rec.work2 is not None and rec.work2.last and rec.work2.req is req:
                self._take_first(req, rec.pre2)
                rec.work2 = None
            if rec.fetch is not None and rec.reqs.get(slot) is req:
                del rec.reqs[slot]
                self._take_decode(slot, req, rec)
        assert req.in_flight == 0 and req.in_flight_steps == 0, (
            "victim drain left tokens in flight")

    def _finish(self, slot: int, req: Request, step: int) -> None:
        req.done = True
        req.finish_step = step
        n_decode_tokens = len(req.out_tokens) - 1
        if n_decode_tokens > 0 and req.first_token_step >= 0:
            self.stats.per_token_samples.append(
                (req.finish_step - req.first_token_step) / n_decode_tokens
            )
        self.tracer.on_finish(self.replica, req, step, slot)
        self._release_slot(slot, req)

    def _release_slot(self, slot: int, req: Request) -> None:
        if self.slots[slot] is not req:
            return                  # slot already recycled past this record
        self.slots[slot] = None
        if self.cache_kind == "paged":
            self.manager.free_slot(slot)
            # dying registered blocks may spill host-ward: copy before the
            # freed device blocks can be reallocated and rewritten
            self._apply_pool_directives()
            self._sync_freed(slot)
        else:
            kv_cache.reset_slot(self.cache, slot)

    def _sync_freed(self, slot: int) -> None:
        """Push a freed slot's empty rows: its block table and length, and
        with a host tier its host table and cold length.  (The reference
        leaves a freed slot's device cold length as it was, so a later
        request in a slot that had spilled would attend with the old
        request's cold window; the port resets it here.)"""
        paged_dev.sync_slot(self.cache, slot, self.manager.tables[slot], 0)
        if self.host_blocks:
            paged_dev.sync_host_slot(self.cache, slot, self.manager.host_tables[slot], 0)

    # ------------------------------------------- admission (whole prefill)
    def _prefill_cost(self, n_tokens: int) -> int:
        """Whole-prefill step cost, in fixed hybrid-batch units."""
        return max(1, -(-n_tokens // self.prefill_chunk))

    def _admit(self):
        if self.cache_kind == "paged":
            self._admit_paged()
            return
        for slot in self._free_slots():
            if not len(self.sched):
                break
            req = self.sched.pop()
            step0 = self.stats.engine_steps
            self.stats.engine_steps += self._prefill_cost(len(req.prompt))
            if req.admit_step < 0:
                req.admit_step = self.stats.engine_steps
            self._trace_admission(req, slot, step0, len(req.prompt), refold=False)
            prompt = paged_dev.to_device(np.asarray(req.prompt, np.int64)[None],
                                         self.device)
            kv_cache.reset_slot(self.cache, slot)
            logits, _ = self.model.prefill(self.params, prompt,
                                           kv_cache.slot_view(self.cache, slot))
            self.slots[slot] = req
            self._draft_prefill_slot(slot, np.asarray(req.prompt, np.int32))
            self._sample_prefill(req, slot, logits)

    def _admit_paged(self):
        """Admit while slots AND blocks allow; the head of the queue waits
        for blocks (FCFS).  A preempted request re-enters with its
        generated tokens folded into the prefill."""
        bs = self.block_size
        for slot in self._free_slots():
            if not len(self.sched):
                break
            req = self.sched.peek()
            full = self._refold(req)
            res = self.manager.try_admit(slot, full)
            if res is None:
                break                       # out of blocks: wait
            self.sched.pop()
            step0 = self.stats.engine_steps
            self.stats.engine_steps += self._prefill_cost(len(full))
            if req.admit_step < 0:
                req.admit_step = self.stats.engine_steps
            self._trace_admission(req, slot, step0, len(full), refold=bool(req.out_tokens))
            blocks, n_cached = res
            # host-tier prefix hits re-hydrate: apply the copies before the
            # prefill's own block writes go out
            self._apply_pool_directives()
            pad = -(-len(full) // bs) * bs
            sub_cache = self.model.init_cache(1, pad)
            logits, _ = self.model.prefill(
                self.params, paged_dev.to_device(full.astype(np.int64)[None], self.device),
                sub_cache)
            # fill only the blocks the prefix cache does not already hold
            for j in range(n_cached, len(blocks)):
                paged_dev.write_prompt_block(self.cache, sub_cache, blocks[j], j * bs)
            paged_dev.sync_slot(self.cache, slot, self.manager.tables[slot], len(full))
            self.slots[slot] = req
            self._draft_prefill_slot(slot, full)
            self._sample_prefill(req, slot, logits)

    def _sample_prefill(self, req: Request, slot: int, logits: torch.Tensor):
        req.admit_base = len(req.out_tokens)
        if self.async_mode:
            # sample on the device and feed tok_state; the id is read
            # lazily with the step stream, the host never waits here
            tok = sample_on_device(logits, self._gen_dev, self.sampler)
            paged_dev.feed_token(self._tok_state, slot, tok)
            paged_dev.set_stop_id(self._eos_dev, slot, req.eos_id)
            req.in_flight += 1
            req.in_flight_steps += 1
            self._first_pending.append((req, _Fetch(tok)))
        else:
            req.out_tokens.append(int(sample(logits, self._gen_host, self.sampler)[0]))
        self._record_first_token(req, slot)

    def _record_first_token(self, req: Request, slot: int) -> None:
        first = req.first_token_step < 0
        if first:
            req.first_token_step = self.stats.engine_steps
            ttft = req.first_token_step - req.submit_step
            self.stats.ttft_steps_sum += ttft
            self.stats.ttft_count += 1
            self.stats.ttft_samples.append(ttft)
        self.stats.prefills += 1
        self.stats.generated += 1
        self.tracer.on_first_token(self.replica, req, self.stats.engine_steps, slot,
                                   first=first)

    # --------------------------------------------- admission (chunked/hybrid)
    def _begin_prefill(self, req: Request, slot: int,
                       unwritten: frozenset[int] = frozenset()) -> tuple[int, int]:
        """Pin ``req``'s (possibly re-folded) prompt for chunked prefill;
        returns (first chunk position, total tokens).  ``unwritten``: pool
        blocks registered for a chunk of this very dispatch, whose K/V are
        not written yet; the prompt is recomputed from the first of them
        it matches (see :meth:`_boundary_chunk`)."""
        full = self._refold(req)
        self._pf_tokens[slot] = full
        if self.cache_kind != "paged":
            self._pf_prefix[slot] = 0
            return 0, len(full)
        bs = self.block_size
        # a free staging lane: the boundary-packed newcomer takes the lane
        # the finishing prompt does not hold
        lane = 0 if 0 not in self._pf_lane.values() else 1
        self._pf_lane[slot] = lane
        matched = self.manager.begin_chunked(slot, full)
        # host-tier hits re-hydrate into fresh device blocks: the copies
        # land before the staging reads below consume them
        self._apply_pool_directives()
        self._pf_prefix[slot] = len(matched)
        for j, phys in enumerate(matched):
            paged_dev.read_block(self.staging, self.cache, phys, j * bs, lane)
        # a fully prefix-cached prompt still recomputes its last chunk for
        # the first-token logits (pool writes for matched blocks skip)
        start = min(len(matched) * bs, (len(full) - 1) // bs * bs)
        first_unwritten = next((j for j, b in enumerate(matched) if b in unwritten), None)
        if first_unwritten is not None:
            start = min(start, first_unwritten * bs)
        return start, len(full)

    def _begin_next(self) -> None:
        """Pin the head of the queue as the in-flight prefill when no
        prompt is mid-flight and a slot is free."""
        sched = self.sched
        if sched.inflight is None and len(sched):
            free = self._free_slots()
            if free:
                req = sched.pop()
                slot = free[0]
                start, total = self._begin_prefill(req, slot)
                sched.begin(req, slot, start, total)
                if req.admit_step < 0:
                    req.admit_step = self.stats.engine_steps + 1
                self.tracer.on_admit(self.replica, req, self.stats.engine_steps, slot,
                                     n_tokens=total, refold=bool(req.out_tokens))

    def _complete_chunk(self, work: PrefillChunk, pre_logits, advance: bool = True):
        """Commit an executed chunk (sync mode: the first token is sampled
        on the host when the chunk completes the prompt).  ``advance=False``
        when the scheduler was already advanced at boundary-packing time."""
        self._trace_chunk(work)
        self._flush_chunk_blocks(work)
        if advance:
            self.sched.advance(work)
        if work.last:
            req = work.req
            self.slots[work.slot] = req
            if self.cache_kind == "paged":
                paged_dev.sync_slot(self.cache, work.slot, self.manager.tables[work.slot],
                                    work.start + work.n_valid)
            self._end_prefill(work.slot)
            self._sample_prefill(req, work.slot, pre_logits)

    def _complete_chunk_async(self, work: PrefillChunk, advance: bool = True):
        """Async twin of :meth:`_complete_chunk`: the step already sampled
        the first token on the device and spliced it into ``tok_state``;
        the host does block/table bookkeeping (stream order puts it after
        the step) and records one more token in flight."""
        self._trace_chunk(work)
        self._flush_chunk_blocks(work)
        if advance:
            self.sched.advance(work)
        if work.last:
            req = work.req
            self.slots[work.slot] = req
            if self.cache_kind == "paged":
                paged_dev.sync_slot(self.cache, work.slot, self.manager.tables[work.slot],
                                    work.start + work.n_valid)
            self._draft_prefill_slot(work.slot, self._pf_tokens[work.slot])
            self._end_prefill(work.slot)
            req.admit_base = len(req.out_tokens)
            req.in_flight += 1
            req.in_flight_steps += 1
            paged_dev.set_stop_id(self._eos_dev, work.slot, req.eos_id)
            self._record_first_token(req, work.slot)

    def _end_prefill(self, slot: int) -> None:
        self._pf_tokens.pop(slot, None)
        self._pf_prefix.pop(slot, None)
        self._pf_lane.pop(slot, None)

    def _chunk_block_range(self, work: PrefillChunk) -> range:
        """Indices of the pool blocks a paged chunk writes when it
        completes (those under its prompt's prefix-cache hits are valid)."""
        bs = self.block_size
        return range(max(work.start // bs, self._pf_prefix.get(work.slot, 0)),
                     (work.start + work.n_valid - 1) // bs + 1)

    def _unwritten_blocks(self, work: PrefillChunk) -> frozenset[int]:
        if self.cache_kind != "paged":
            return frozenset()
        return frozenset(self.manager.blocks[work.slot][j] for j in self._chunk_block_range(work))

    def _flush_chunk_blocks(self, work: PrefillChunk) -> None:
        if self.cache_kind != "paged":
            return
        lane = self._pf_lane.get(work.slot, 0)
        for j in self._chunk_block_range(work):
            paged_dev.write_prompt_block(self.cache, self.staging,
                                         self.manager.blocks[work.slot][j],
                                         j * self.block_size, lane)

    # ----------------------------------------------------- block management
    def _apply_pool_directives(self) -> None:
        """Drain the pool's device<->host copy directives into block copies.
        Runs after every manager/pool call that can spill or re-hydrate,
        before anything else is issued that could rewrite an involved
        block: stream order then puts the copy ahead of it."""
        for kind, a, b in self.pool.drain_directives():
            if kind == "spill":
                paged_dev.spill_block(self.cache, a, b)
                self.stats.spills += 1
                self.tracer.on_spill(self.replica, self.stats.engine_steps, a, b)
            else:
                paged_dev.rehydrate_block(self.cache, a, b)
                self.stats.rehydrations += 1
                self.tracer.on_rehydrate(self.replica, self.stats.engine_steps, a, b)

    def _try_spill(self, alive) -> bool:
        """Spill-before-evict: free one device block by moving the oldest
        sequence's coldest hot block to the host tier.  That sequence keeps
        decoding (hot and cold windows, lse-merged), with no re-prefill.
        False when nothing can spill (no qualifying block, or the host tier
        is full)."""
        for s in sorted(alive, key=lambda x: self.manager.admit_seq[x]):
            if self.slots[s] is None:
                continue
            if self.manager.spill_live_prefix(s, self._kv_len(s)):
                self._apply_pool_directives()
                paged_dev.sync_slot(self.cache, s, self.manager.tables[s])
                paged_dev.sync_host_slot(self.cache, s, self.manager.host_tables[s],
                                         self.manager.cold_len(s))
                return True
        return False

    def _kv_len(self, slot: int) -> int:
        """KV positions held for ``slot`` (its last sampled token is the
        next step's input, not yet appended), counting in-flight tokens:
        the async engine plans from dispatched, not observed, state."""
        req = self.slots[slot]
        return len(req.prompt) + len(req.out_tokens) + req.in_flight - 1

    def _append_span(self, slot: int) -> tuple[int, int]:
        """Inclusive position range [lo, hi] the slot's next dispatch may
        write.  With speculative windows in flight the device length lies
        in [committed + steps, committed + charges], and the next window
        writes ``spec_depth`` positions past its start; without
        speculation lo == hi, the single append position."""
        req = self.slots[slot]
        base = len(req.prompt) + len(req.out_tokens)
        return (base + req.in_flight_steps - 1,
                base + req.in_flight - 1 + self.spec_depth)

    def _preempt(self, slot: int):
        """Evict ``slot`` to the queue front; its blocks return to the
        pool and its tokens are recomputed at re-admission."""
        req = self.slots[slot]
        self.slots[slot] = None
        self.manager.free_slot(slot)
        self._apply_pool_directives()
        self._sync_freed(slot)
        self.sched.push_front(req)
        self.stats.preemptions += 1
        self.pool.stats.preemptions += 1
        self.tracer.on_preempt(self.replica, req, self.stats.engine_steps, slot)

    def _prepare_append(self, active: list[int]) -> list[int]:
        """Guarantee every active slot can write its next token: allocate
        boundary blocks, copy-on-write shared tails, and when the pool runs
        dry spill a cold prefix block to the host tier (if there is one)
        or else preempt the youngest sequence.  Returns the surviving slots.

        Async: only the victim's in-flight tokens are observed first
        (:meth:`_observe_victim`); they may reveal it already finished,
        and then nothing is evicted.  Only when the victim is alive is the
        rest of the pipeline drained, since an unobserved EOS elsewhere
        may free enough blocks to avoid the re-prefill."""
        alive = set(active)
        limit = self.max_blocks * self.block_size
        for slot in sorted(active, key=lambda s: self.manager.admit_seq[s]):
            pos = None
            while slot in alive:
                if self.slots[slot] is None:
                    alive.discard(slot)     # retired during a drain below
                    break
                lo, hi = self._append_span(slot)
                if pos is None or pos < lo:
                    pos = lo
                if pos > hi or pos >= limit:
                    break       # mapped (or at the cache top: the write is clamped)
                directive, payload = self.manager.ensure_append(slot, pos)
                if directive == "oom":
                    if self.host_blocks and self._try_spill(alive):
                        continue        # freed a block without evicting anyone
                    victim = self.manager.youngest(alive)
                    self._observe_victim(victim)
                    if self.slots[victim] is None:
                        alive.discard(victim)   # finished: blocks already free
                        continue
                    if self._pending or self._first_pending:
                        self._drain()           # settle completions elsewhere
                        alive = {s for s in alive if self.slots[s] is not None}
                        continue
                    self._preempt(victim)
                    alive.discard(victim)
                    continue
                if directive == "cow":
                    src, dst = payload
                    paged_dev.copy_block(self.cache, src, dst)
                if directive in ("cow", "new"):
                    paged_dev.sync_slot(self.cache, slot, self.manager.tables[slot])
                pos += 1
        return [s for s in active if s in alive]

    # ------------------------------------------------------ hybrid dispatch
    def _plan(self, decision) -> tuple[list[int], PrefillChunk | None]:
        """The scheduler's decode batch and chunk; a paged chunk runs only
        if its blocks can be had (else a decode-only step)."""
        work = decision.prefill
        if work is not None and self.cache_kind == "paged":
            if not self.manager.extend_chunked(
                    work.slot, len(self._pf_tokens[work.slot]),
                    work.start + work.n_valid, work.last):
                work = None
        return decision.decode_slots, work

    def _boundary_chunk(self, budget: int, work: PrefillChunk) -> PrefillChunk | None:
        """The final chunk ``work`` left ``budget`` tokens of this step
        unused: begin the next queued prompt and pack its head chunk into
        the same dispatch (Sarathi-SC).  ``work``'s slot is excluded from
        the slot choice: the finishing prompt claims it only after this
        dispatch.

        The newcomer may share a prefix with the finishing prompt, whose
        blocks for ``work`` are registered in the pool's prefix hash but
        written only after this dispatch.  The reference engine reads
        them into the newcomer's staging lane all the same, so the
        newcomer attends over whatever those blocks held before (its
        tokens then depend on the pool's history, and differ between sync
        and async runs).  The port recomputes the newcomer's prompt from
        the first such block instead; the blocks stay shared (the pool's
        bookkeeping is the reference's), the step clock may differ."""
        sched = self.sched
        if budget <= 0 or sched.inflight is not None or not len(sched):
            return None
        if self.cache_kind == "paged" and len(self._pf_lane) >= 2:
            return None             # both staging lanes held
        free = [s for s in self._free_slots() if s != work.slot]
        if not free:
            return None
        req = sched.pop()
        slot = free[0]
        start, total = self._begin_prefill(req, slot, self._unwritten_blocks(work))
        sched.begin(req, slot, start, total)
        if req.admit_step < 0:
            req.admit_step = self.stats.engine_steps
        self.tracer.on_admit(self.replica, req, self.stats.engine_steps, slot,
                             n_tokens=total, refold=bool(req.out_tokens))
        work2 = sched.pack_boundary(budget)
        if work2 is not None and self.cache_kind == "paged":
            if not self.manager.extend_chunked(
                    work2.slot, len(self._pf_tokens[work2.slot]),
                    work2.start + work2.n_valid, work2.last):
                return None         # pool dry now: B's chunks run later
        return work2

    def _pack(self, active: list[int], work: PrefillChunk | None):
        """The chunks of this dispatch with their device token arrays:
        ``work``, plus a boundary-packed second chunk when ``work``
        finishes its prompt.  Returns (chunks, whether the scheduler was
        already advanced past ``work``)."""
        if work is None:
            return [], False
        chunks = [(work, self._chunk_tokens(work))]
        # no boundary packing under speculation: the reference's fused2
        # programs have no speculative variant
        if not (work.last and len(self.sched)) or self.spec_depth:
            return chunks, False
        self.sched.advance(work)        # A rides this dispatch regardless
        work2 = self._boundary_chunk(
            self.sched.token_budget - len(active) - work.n_valid, work)
        if work2 is not None:
            chunks.append((work2, self._chunk_tokens(work2)))
            self.stats.boundary_packs += 1
        return chunks, True

    def _chunk_tokens(self, work: PrefillChunk) -> np.ndarray:
        """The chunk's tokens, zero-padded to ``prefill_chunk``: every chunk
        runs at one shape, so a token's K/V and logits do not depend on
        where a chunk boundary falls (the GEMMs' kernels, and so their
        rounding, depend on the row count).  Speculation turns boundary
        packing off and so moves boundaries; its greedy tokens stay the
        plain engine's."""
        chunk = np.zeros((1, self.prefill_chunk), np.int32)
        chunk[0, :work.n_valid] = self._pf_tokens[work.slot][
            work.start:work.start + work.n_valid]
        return chunk

    def _chunk_scalars(self, work: PrefillChunk) -> tuple[int, int, int, int, int]:
        """A chunk's program scalars ``(slot, lane, start, n_valid, last)``;
        the lane is the paged engine's staging lane (0 on the dense cache)."""
        lane = self._pf_lane.get(work.slot, 0) if self.cache_kind == "paged" else 0
        return work.slot, lane, work.start, work.n_valid, int(work.last)

    def _run_chunk(self, tokens: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
        """One chunk through ``prefill_step`` at the device scalars ``sc``:
        into the slot's stripe of the dense cache, or into the paged
        engine's staging lane."""
        if self.cache_kind == "paged":
            cache, row = self.staging, sc[1:2]
        else:
            cache, row = self.cache, sc[0:1]
        logits, _ = self.model.prefill_step(self.params, cache, tokens, row, sc[2:3], sc[3:4])
        return logits

    def _hold_lengths(self, scalars) -> None:
        """Dense cache: the decode advanced every slot's length, the
        mid-prefill slots' too; set those back to their chunk ends (their
        garbage append is overwritten by the next chunk or decode token).
        ``scalars``: each chunk's device ``(slot, lane, start, n_valid,
        last)``."""
        if self.cache_kind == "dense":
            lengths = self.cache["lengths"]
            for sc in scalars:
                lengths.index_put_((sc[0:1].long(),), sc[2:3] + sc[3:4])

    def _exec(self, active: list[int], chunks) -> tuple[tuple[torch.Tensor, ...], _Dispatch]:
        """One dispatch of the decode batch ``active`` and the prefill
        ``chunks`` through its kind's program (:meth:`_dispatch_body`
        says what it returns; the outputs are valid until the next
        dispatch of the kind), fenced by the profiler when it samples
        this dispatch.  A dispatch that captures its kind's graph is not
        counted by the profiler."""
        kind = self._dispatch_kind(active, chunks)
        values = {}
        if active and not self.async_mode:
            values["tokens"] = self._decode_tokens()
        for i, (work, tokens) in enumerate(chunks):
            values[f"tok{i}"] = tokens
            values[f"chunk{i}"] = self._chunk_scalars(work)
        self.dispatch_counts[kind] += 1
        prog = self._program(kind)
        captures = prog.graphs and prog.graph is None
        prof = self.profiler
        sampled = prof.enabled and not captures and prof.tick()
        if sampled:
            prof.begin(self.device)         # settle in-flight steps
        if len(chunks) == 2:
            work2 = chunks[1][0]
            self.tracer.on_boundary_pack(self.replica, work2.req, self.stats.engine_steps,
                                         work2.slot)
        out = prog(**values)
        if sampled:
            prof.end(self.device)
        return out, _Dispatch(kind, sampled, captures)

    # ------------------------------------------------------------ telemetry
    def _trace_admission(self, req: Request, slot: int, step0: int, n_tokens: int,
                         refold: bool) -> None:
        """A whole-prompt admission (decode-only schedule): the admission
        mark, one chunk span over its ``ceil(L / prefill_chunk)``-step cost
        and, traced, its prefill StepRecord."""
        self.tracer.on_admit(self.replica, req, step0, slot, n_tokens=n_tokens, refold=refold)
        self.tracer.on_chunk(self.replica, req, slot, step0, self.stats.engine_steps, 0,
                             n_tokens, None, True)
        if self.tracer.enabled:
            self._trace_prefill_dispatch(n_tokens, self.stats.engine_steps - step0)

    def _trace_chunk(self, work: PrefillChunk) -> None:
        """An executed chunk of the dispatch just counted, with the
        reference's bucket."""
        if self.tracer.enabled:
            self.tracer.on_chunk(self.replica, work.req, work.slot, self.stats.engine_steps - 1,
                                 self.stats.engine_steps, work.start, work.n_valid,
                                 chunk_bucket(self.prefill_chunk, work.n_valid), work.last)

    def _trace_dispatch(self, d: _Dispatch, active: list[int],
                        works: list[PrefillChunk]) -> None:
        """After a dispatch is counted on the step clock: note a capture,
        and with telemetry on, the speculative proposal mark and the
        dispatch's StepRecord, joined with the profiler's fenced time when
        it sampled the dispatch."""
        if d.captured:
            self.capture_steps[d.kind] = self.stats.engine_steps
        if not self._telemetry:
            return
        if d.kind in ("spec", "spec_fused") and self.tracer.enabled:
            self.tracer.on_spec_propose(self.replica, self.stats.engine_steps,
                                        self.spec_depth, len(active))
        rec = self._trace_step(d.kind, active, works)
        if d.sampled:
            self.profiler.commit(rec)

    def _pool_use(self) -> dict[str, float | None]:
        """A StepRecord's block-pool and host-tier utilization (None
        without a pool or a tier)."""
        paged = self.cache_kind == "paged"
        return dict(pool_util=self.pool.utilization if paged else None,
                    host_util=self.pool.host_utilization if paged and self.host_blocks else None)

    def _trace_prefill_dispatch(self, n_tokens: int, n_steps: int) -> StepRecord:
        """StepRecord for a whole-prompt admission prefill (decode-only
        schedule), charged at its ``ceil(L / prefill_chunk)``-step cost."""
        cm = self._cost_model
        ctx = cm.chunk_ctx_tokens(0, n_tokens)
        flops, bytes_ = cm.cost(0, 0, n_tokens, ctx)
        rec = StepRecord(
            replica=self.replica, step=self.stats.engine_steps,
            kind="prefill", decode_batch=0, prefill_tokens=n_tokens,
            bucket=None, bucket2=None,
            budget=n_steps * self.prefill_chunk,
            fill=n_tokens / max(n_steps * self.prefill_chunk, 1),
            kv_tokens=0, **self._pool_use(),
            pipeline_depth=len(self._pending),
            flops=flops, bytes=bytes_, oi=flops / max(bytes_, 1.0),
            wall=self.tracer.wall(),
        )
        self.tracer.on_step(rec)
        return rec

    def _trace_step(self, kind: str, active: list[int],
                    works: list[PrefillChunk]) -> StepRecord:
        """StepRecord for one decode/fused dispatch: composition (batch,
        chunks, budget fill, pool pressure, pipeline depth) plus analytic
        FLOPs/bytes, from host bookkeeping only (no device reads).  Returns
        the record, already handed to the tracer, for the profiler's join."""
        cm = self._cost_model
        kv = 0
        for i in active:
            r = self.slots[i]
            kv += len(r.prompt) + len(r.out_tokens) + r.in_flight
        pre = ctx = 0
        for w in works:
            pre += w.n_valid
            ctx += cm.chunk_ctx_tokens(w.start, w.n_valid)
        buckets = [chunk_bucket(self.prefill_chunk, w.n_valid) for w in works] + [None, None]
        budget = self.sched.token_budget if self.schedule == "hybrid" else len(self.slots)
        flops, bytes_ = cm.cost(len(active), kv, pre, ctx)
        rec = StepRecord(
            replica=self.replica, step=self.stats.engine_steps, kind=kind,
            decode_batch=len(active), prefill_tokens=pre,
            bucket=buckets[0], bucket2=buckets[1],
            budget=budget, fill=(len(active) + pre) / max(budget, 1),
            kv_tokens=kv, **self._pool_use(),
            pipeline_depth=len(self._pending),
            flops=flops, bytes=bytes_, oi=flops / max(bytes_, 1.0),
            wall=self.tracer.wall(),
        )
        self.tracer.on_step(rec)
        return rec

    # ----------------------------------------------------------------- step
    def _decode_tokens(self) -> np.ndarray:
        tokens = np.zeros((len(self.slots),), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None and req.out_tokens:
                tokens[i] = req.out_tokens[-1]
        return tokens

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
        if self.schedule == "hybrid":
            return self._step_hybrid_async() if self.async_mode else self._step_hybrid()
        if self.async_mode:
            return self._step_decode_only_async()
        return self._step_decode_only()

    def _busy(self) -> bool:
        return any(s is not None for s in self.slots) or self.sched.has_work()

    def _step_decode_only(self) -> bool:
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if self.cache_kind == "paged" and active:
            active = self._prepare_append(active)
        if not active:
            return self.sched.has_work()
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        (logits,), d = self._exec(active, [])
        self.stats.decode_steps += 1
        self.stats.engine_steps += 1
        self._trace_dispatch(d, active, [])
        self._finish_decode(active, logits)
        return self._busy()

    def _step_decode_only_async(self) -> bool:
        self._admit()
        active = self._predicted_active()
        if self.cache_kind == "paged" and active:
            active = self._prepare_append(active)
        if not active:
            self._drain()               # nothing to dispatch: settle state
            return self._busy()
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        out, d = self._exec(active, [])
        fetch = _Fetch(*out)
        self.stats.decode_steps += 1
        self.stats.engine_steps += 1
        self._trace_dispatch(d, active, [])
        self._dispatch(self._decode_record(active, fetch))
        return True

    def _dispatch_kind(self, active: list[int], chunks: list) -> str:
        """The reference's jit program for a dispatch of the decode batch
        ``active`` and the prefill ``chunks``."""
        spec = bool(self.spec_depth and active)
        if len(chunks) == 2:
            return "fused2" if active else "solo2"
        if chunks:
            return ("spec_fused" if spec else "fused") if active else "solo"
        return "spec" if spec else "decode"

    def _decode_record(self, active: list[int], fetch: _Fetch | None) -> _PendingStep:
        """The pending record of a dispatched decode batch: every slot of it
        charged one in-flight token, or ``k+1`` for a speculative window
        (counted in the spec stats here)."""
        spec = bool(self.spec_depth and active)
        charge = self.spec_depth + 1 if spec else 1
        if spec:
            self.stats.spec_steps += 1
            self.stats.draft_steps += charge
        reqs = {}
        for i in active:
            req = self.slots[i]
            req.in_flight += charge
            req.in_flight_steps += 1
            reqs[i] = req
        return _PendingStep(step=self.stats.engine_steps, reqs=reqs, fetch=fetch,
                            spec=spec, charge=charge)

    def _step_hybrid(self) -> bool:
        self._begin_next()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if self.cache_kind == "paged" and active:
            active = self._prepare_append(active)
        active, work = self._plan(self.sched.schedule(active))
        if not active and work is None:
            return self.sched.has_work()
        self.stats.engine_steps += 1
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        chunks, pre_advanced = self._pack(active, work)
        out, d = self._exec(active, chunks)
        self._trace_dispatch(d, active, [w for w, _ in chunks])
        if active:
            self.stats.decode_steps += 1
            self._finish_decode(active, out[0])
        for i, ((w, _), lg) in enumerate(zip(chunks, out[1 if active else 0:])):
            self.stats.prefill_chunks += 1
            self._complete_chunk(w, lg, advance=not (i == 0 and pre_advanced))
        return self._busy()

    def _step_hybrid_async(self) -> bool:
        self._begin_next()
        active = self._predicted_active()
        if self.cache_kind == "paged" and active:
            active = self._prepare_append(active)
        active, work = self._plan(self.sched.plan_ahead(active))
        if not active and work is None:
            self._drain()
            return self._busy()
        self.stats.engine_steps += 1
        self.stats.peak_active = max(self.stats.peak_active, len(active))
        chunks, pre_advanced = self._pack(active, work)
        out, d = self._exec(active, chunks)
        fetch = _Fetch(*out[:2]) if active else None
        pre = [_Fetch(t) for t in out[2 if active else 0:]]
        if active:
            self.stats.decode_steps += 1
        self._trace_dispatch(d, active, [w for w, _ in chunks])
        rec = self._decode_record(active, fetch)
        if chunks:
            rec.work, rec.pre = chunks[0][0], pre[0]
        if len(chunks) == 2:
            rec.work2, rec.pre2 = chunks[1][0], pre[1]
        for i, (w, _) in enumerate(chunks):
            self.stats.prefill_chunks += 1
            self._complete_chunk_async(w, advance=not (i == 0 and pre_advanced))
        self._dispatch(rec)
        return True

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if not self.step():
                break
        if self.async_mode:
            self._drain()           # settle out_tokens if max_steps truncated
        return self.stats

    def kv_bytes(self) -> int:
        """Physical KV footprint of the resident cache (the staging cache
        excluded, as in the reference)."""
        return kv_cache.kv_bytes(self.cache)
