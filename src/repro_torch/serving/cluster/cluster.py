"""N engine replicas behind one admission/routing front-end.

Counterpart of ``repro.serving.cluster.cluster``.  The paper scales KV
capacity by adding HPU cards; the serving-tier analogue is data-parallel
engine replicas — each :class:`Engine` owns its own cache, scheduler,
block pool and CUDA graphs, and all of them share one params set on one
device, or each holds its own (``model_factory(i)``, when given, builds
replica *i*'s model and weights) — with a **shared global request queue**
in front.

Under a ``torch.distributed`` world the replicas may each have a mesh of
their own (``launch.mesh.replica_meshes``; ``model_factory`` builds each
on its mesh).  Every rank then runs this whole host loop — the global
queue, the router, the roles, migration and refold moves — over every
replica: on the ranks of a replica's mesh its engine has the device
state, elsewhere it is a mirror (``Engine.member``) that keeps the same
host bookkeeping and learns what the device returned by broadcast.
Every rank reaches the same decisions, and :meth:`Cluster.stats` is the
same on every rank.  A migrating request's KV is gathered whole on the
source's mesh and sent from its first rank to each rank of the
destination's (:meth:`Cluster._handoff`).
Requests wait globally and are placed by a
:class:`~repro_torch.serving.cluster.router.Router` the moment some replica
can admit them, so placement decisions always see current load and
current prefix residency, not submission-time state.

Stepping is an interleaved loop: one cluster *round* dispatches the
queue, then steps every replica once.  Replicas never block each other —
a replica with nothing to do returns from ``step`` immediately — and the
async dispatch-ahead pipeline inside each engine keeps device work
queued across the round exactly as it does standalone.  On one card the
replicas' programs run in one stream's order, so tokens per round, not
tokens per second, is the scaling figure.

Dispatch is FCFS with head-of-line blocking: when no replica can admit
the queue head, the whole queue waits (mirrors each engine's own FCFS
admission, keeps preempted-request recovery exact, and makes cluster
output order deterministic).  Greedy outputs are token-identical
per request to a single engine serving the same prompts — routing moves
work, never changes it.

Disaggregated serving (``roles=``)
----------------------------------
The paper's thesis is splitting memory-bound attention from
compute-bound GEMMs across device classes; the cluster expresses it as
replica **roles**.  ``roles`` (see :func:`parse_roles`) marks each
replica ``prefill`` / ``decode`` / ``mixed``:

* new prompts are only admitted to prefill/mixed replicas;
* after each round, every resident (prefill-complete) request on a
  ``prefill``-role replica is **migrated** to the least-loaded decode
  target that can take it — ``Engine.export_request`` gathers its KV
  blocks in storage dtype, ``Engine.import_request`` lands them in place
  (deduped against the destination's prefix cache) and decode resumes with the
  same next-input token over the same KV, so greedy output is
  token-identical to never having migrated;
* a request whose migration finds no destination simply keeps decoding
  on its prefill replica and is retried next round (graceful
  degradation, never a stall).

The same machinery levels bursty tails on any role layout: a preempted
request waiting at a replica's local queue front refolds on the
least-loaded admitting replica instead of its home when home cannot
take it next step (router-driven refold placement).

Round-clock TTFT: each engine's TTFT excludes the *global* queue wait
(the request has no home replica while it waits), so the cluster also
records submit-round -> first-token-round per request
(``ClusterStats.ttft_rounds_samples``) — the end-to-end latency metric
the disaggregation benchmark gates on.
"""
from __future__ import annotations

import re
from collections import deque

from repro_torch.distributed import collectives
from repro_torch.launch.mesh import world
from repro_torch.serving.cluster.router import Router
from repro_torch.serving.cluster.stats import ClusterStats, ReplicaStats
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.telemetry import NULL_TRACER

Pytree = object

ROLES = ("prefill", "decode", "mixed")


def parse_roles(spec, n_replicas: int) -> list[str]:
    """Resolve a role specification into one role per replica.

    Accepts ``None`` (all ``mixed`` — the non-disaggregated default), an
    explicit list/tuple, a comma list (``"prefill,decode"``), or the
    ``"<k>P+<m>D"`` shorthand (optionally ``+<j>M``): ``"2P+2D"`` is two
    prefill replicas followed by two decode replicas.  Validates that at
    least one replica can admit prompts and that prefill/decode replicas
    are not stranded without a counterpart.
    """
    if spec is None:
        return ["mixed"] * n_replicas
    if isinstance(spec, str):
        s = spec.strip().lower()
        m = re.fullmatch(r"(\d+)p\+(\d+)d(?:\+(\d+)m)?", s)
        if m:
            roles = (["prefill"] * int(m.group(1))
                     + ["decode"] * int(m.group(2))
                     + ["mixed"] * int(m.group(3) or 0))
        else:
            roles = [r.strip() for r in s.split(",")]
    else:
        roles = [str(r) for r in spec]
    if len(roles) != n_replicas:
        raise ValueError(
            f"role map {spec!r} names {len(roles)} replicas, cluster has "
            f"{n_replicas}"
        )
    for r in roles:
        if r not in ROLES:
            raise ValueError(f"unknown role {r!r} (known: {', '.join(ROLES)})")
    if not any(r in ("prefill", "mixed") for r in roles):
        raise ValueError("no admission target: need a prefill or mixed replica")
    if "prefill" in roles and not any(r in ("decode", "mixed") for r in roles):
        raise ValueError(
            "prefill replicas need a decode or mixed replica to migrate to"
        )
    if "decode" in roles and "prefill" not in roles:
        raise ValueError(
            "decode replicas sit idle without a prefill replica migrating "
            "work to them (use 'mixed' instead)"
        )
    return roles


class Cluster:
    def __init__(
        self,
        model,
        params: Pytree,
        n_replicas: int,
        route: str = "round_robin",
        roles=None,
        tracer=None,
        profiler=None,
        model_factory=None,
        role_kw: dict[str, dict] | None = None,
        **engine_kw,
    ):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.profiler = profiler
        if world()[1] > 1 and (self.tracer.enabled or (profiler and profiler.enabled)):
            raise NotImplementedError(
                "tracing and profiling a cluster on more than one rank wait for "
                "ROADMAP item 9b.4 (telemetry across ranks)")
        self.roles = parse_roles(roles, n_replicas)
        role_kw = role_kw or {}
        self.engines = []
        for i, role in enumerate(self.roles):
            # role_kw lets a role override engine knobs (e.g. decode
            # replicas run more slots: they hold the long decode phase
            # while prefill replicas only stage short-lived prefills)
            kw = {**engine_kw, **role_kw.get(role, {})}
            # the port's factory gives the replica's weights too (a rank
            # holds shards of its own mesh's, none of another's) and engine
            # keywords of its own (its draft)
            mdl, prm, extra = ((model, params, {}) if model_factory is None
                               else model_factory(i))
            kw.update(extra)
            self.engines.append(
                Engine(mdl, prm, tracer=self.tracer,
                       profiler=self.profiler, replica=i, role=role, **kw)
            )
        self.router = Router(self.engines, route, tracer=self.tracer,
                             roles=self.roles)
        self._prefill_idx = [i for i, r in enumerate(self.roles)
                             if r == "prefill"]
        self.disaggregated = bool(self._prefill_idx)
        self.max_seq = self.engines[0].max_seq
        self.queue: deque[Request] = deque()
        self.rounds = 0
        self.placement: dict[int, int] = {}    # uid -> current replica
        self._submit_round: dict[int, int] = {}
        self.queue_wait_sum = 0
        self.queue_wait_count = 0
        self.migrations = 0
        self.refold_moves = 0
        # round-clock TTFT: uid -> (request, submit round) until its
        # first token is produced on whichever replica holds it
        self._ttft_pending: dict[int, tuple[Request, int]] = {}
        self.ttft_rounds_samples: list[int] = []

    # ------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        """Enqueue on the shared global queue (uids must be unique — the
        routed-exactly-once invariant is keyed on them).  The engine's
        own prompt-length check is applied eagerly so an oversized prompt
        fails at submission, not rounds later at dispatch."""
        if len(req.prompt) >= self.max_seq - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit max_seq="
                f"{self.max_seq} (needs len(prompt) <= max_seq - 2)"
            )
        if req.uid in self.placement or req.uid in self._submit_round:
            raise ValueError(f"duplicate request uid {req.uid}")
        self.queue.append(req)
        self._submit_round[req.uid] = self.rounds
        self._ttft_pending[req.uid] = (req, self.rounds)

    def _dispatch_queue(self) -> None:
        """Route queued requests FCFS until the head cannot be admitted
        anywhere (head-of-line wait: it is re-routed next round, when
        completions have freed capacity or moved the affinity target)."""
        while self.queue:
            req = self.queue[0]
            idx = self.router.route(req)
            if idx is None:
                break
            self.queue.popleft()
            assert req.uid not in self.placement, "request routed twice"
            self.placement[req.uid] = idx
            self.queue_wait_sum += self.rounds - self._submit_round.pop(req.uid)
            self.queue_wait_count += 1
            self.engines[idx].submit(req)

    # ------------------------------------------------------------ migration
    def _migrate_prefills(self) -> int:
        """Disaggregated handoff: move every resident (prefill-complete)
        request off ``prefill``-role replicas to the least-loaded decode
        target that can take it now (``Engine.can_import`` probes before
        the export is paid).  A request with no viable destination keeps
        decoding at home and is retried next round."""
        moved = 0
        for src_idx in self._prefill_idx:
            src = self.engines[src_idx]
            for slot, req in enumerate(list(src.slots)):
                if req is None or req.done:
                    continue
                ticket = src.preview_export(slot)
                if ticket is None:
                    continue
                dst_idx = next(
                    (i for i in self.router.rank_decode(exclude=src_idx)
                     if self.engines[i].can_import(ticket)),
                    None,
                )
                if dst_idx is None:
                    continue
                exported = src.export_request(slot)
                if exported is None:
                    continue        # finished while observing in-flight tokens
                req, ticket, payload = exported
                dst = self.engines[dst_idx]
                dslot = dst.import_request(req, ticket, self._handoff(src, dst, payload))
                if dslot is None:
                    # capacity shifted between probe and import (cannot
                    # happen single-threaded; defensive): land it back
                    # home — its blocks were just freed there
                    back = src.import_request(req, ticket, payload)
                    assert back is not None, "migration fallback failed"
                    continue
                self.placement[req.uid] = dst_idx
                self.migrations += 1
                moved += 1
                self.tracer.on_migrate(
                    req, src_idx, ticket.src_step, slot,
                    dst_idx, dst.stats.engine_steps, dslot, ticket.n_blocks,
                )
        return moved

    def _handoff(self, src: Engine, dst: Engine, payload):
        """A migration payload where ``dst`` lands it: the same on one mesh
        (or one process); between two meshes, sent whole from the source's
        first rank to every rank of the destination's, over the world's
        gloo group (pinned host memory for a card).  None on a rank
        outside the destination."""
        s, d = src.model.mesh, dst.model.mesh
        if s is None or d is None or s.ranks == d.ranks:
            return payload
        me = world()[0]
        if me == s.ranks[0]:
            for r in d.ranks:
                collectives.send_tree(payload, r, s.host)
        if me not in d.ranks:
            return None
        return collectives.recv_tree(s.ranks[0], s.host, pin=dst.device.type == "cuda")

    def _rebalance_refolds(self) -> int:
        """Router-driven refold placement: a preempted request waiting at
        a replica's local queue front refolds on the least-loaded
        admitting replica instead of its home, when home cannot admit it
        next step but somewhere else can right now."""
        moved = 0
        for src_idx, src in enumerate(self.engines):
            q = src.sched.queue
            if not q or not q[0].out_tokens or q[0].done:
                continue
            if src.can_admit_next():
                continue            # home takes it next step: leave it
            head = q[0]
            dst_idx = next(
                (i for i in self.router.rank_refold(exclude=src_idx)
                 if self.engines[i].can_admit(head)),
                None,
            )
            if dst_idx is None:
                continue
            req = src.take_refold()
            assert req is head
            dst = self.engines[dst_idx]
            # translate decode-latency accounting onto the new home's
            # step clock (mirrors Engine.import_request)
            if req.first_token_step >= 0:
                req.first_token_step = dst.stats.engine_steps - (
                    src.stats.engine_steps - req.first_token_step
                )
            dst.adopt_refold(req)
            self.placement[req.uid] = dst_idx
            self.refold_moves += 1
            moved += 1
            self.tracer.on_refold_move(req, src_idx, dst_idx)
        return moved

    def _harvest_first_tokens(self) -> None:
        """Record submit-round -> first-token-round samples (the cluster
        TTFT clock; covers the global queue wait each engine's own
        step-clock TTFT cannot see)."""
        done = [uid for uid, (req, _) in self._ttft_pending.items()
                if req.first_token_step >= 0]
        for uid in done:
            req, r0 = self._ttft_pending.pop(uid)
            self.ttft_rounds_samples.append(self.rounds - r0)

    # ----------------------------------------------------------------- step
    def step(self) -> bool:
        """One cluster round: admit from the global queue, step every
        replica once, then migrate finished prefills off prefill-role
        replicas and re-place stranded refolds.  Returns whether any work
        remains."""
        if self.tracer.enabled:
            self.tracer.round = self.rounds
        self._dispatch_queue()
        self.rounds += 1
        busy = False
        for eng in self.engines:
            busy = eng.step() or busy
        if self.disaggregated:
            busy = bool(self._migrate_prefills()) or busy
        if len(self.engines) > 1:
            busy = bool(self._rebalance_refolds()) or busy
        self._harvest_first_tokens()
        return busy or bool(self.queue)

    def run(self, max_rounds: int = 10_000) -> ClusterStats:
        for _ in range(max_rounds):
            if not self.step():
                break
        for eng in self.engines:
            if eng.async_mode:
                eng._drain()    # settle out_tokens if max_rounds truncated
        self._harvest_first_tokens()
        return self.stats()

    # ---------------------------------------------------------------- stats
    def stats(self) -> ClusterStats:
        rs = self.router.stats
        return ClusterStats(
            rounds=self.rounds,
            replicas=[
                ReplicaStats(replica=i, routed=rs.routed[i],
                             n_slots=len(eng.slots), engine=eng.stats,
                             role=eng.role)
                for i, eng in enumerate(self.engines)
            ],
            spills=rs.spills,
            prefix_hit_tokens=rs.prefix_hit_tokens,
            probed_tokens=rs.probed_tokens,
            queue_wait_sum=self.queue_wait_sum,
            queue_wait_count=self.queue_wait_count,
            migrations=self.migrations,
            refold_moves=self.refold_moves,
            ttft_rounds_samples=list(self.ttft_rounds_samples),
        )
