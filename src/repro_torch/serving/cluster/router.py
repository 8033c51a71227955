"""Replica selection: pluggable routing policies with spill-over.

Counterpart of ``repro.serving.cluster.router``.

The router is the cluster's admission front-end brain: given one request
and the live replica set, produce a preference ranking and place the
request on the first ranked replica that can admit it *now*
(``Engine.can_admit``).  Admission off the first choice is a **spill**;
when no replica can admit, the request stays in the cluster's global
queue (FCFS) and is re-routed next round with fresh load/affinity state.

Policies (``ROUTE_POLICIES``):

* ``round_robin`` — cycle through replicas; the baseline, load-blind.
* ``least_loaded`` — ascending in-flight tokens (prompt + generated of
  every resident or locally-queued request, via ``Engine.load``), free
  paged blocks then free slots as tie-breakers.  Keeps heterogeneous
  request lengths from piling onto one replica.
* ``prefix_affinity`` — rank by the longest *resident* prompt prefix on
  each replica (``Engine.probe_prefix`` →
  ``PagedCacheManager.probe_prefix``, a side-effect-free walk of the
  block hash), falling back to the least-loaded ordering among equal
  hits.  Shared-prompt traffic lands where its KV blocks already live,
  so the paged prefix cache actually hits across requests instead of
  being shredded by round-robin placement.

Every route decision — regardless of policy — also *records* the chosen
replica's resident-prefix hit in ``RouterStats``, so a run can
compare the hit-rate a policy achieved without instrumenting engines.

Disaggregated roles (``roles=``): each replica carries a
``{"prefill","decode","mixed"}`` role.  New prompts only ever rank over
the **admission targets** (prefill or mixed); :meth:`Router.rank_decode`
ranks the **decode targets** (decode or mixed) by load for the cluster's
prefill->decode KV migration, and :meth:`Router.rank_refold` ranks the
admission targets by load for router-driven refold placement.  An
all-``mixed`` cluster (the default) behaves exactly as before.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.telemetry import NULL_TRACER

ROUTE_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")


@dataclasses.dataclass
class RouterStats:
    routed: list[int]           # requests placed per replica
    spills: int = 0             # placements off the policy's first choice
    prefix_hit_tokens: int = 0  # resident prefix on the chosen replica
    probed_tokens: int = 0      # total prompt tokens routed

    @property
    def total_routed(self) -> int:
        return sum(self.routed)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.probed_tokens, 1)


class Router:
    def __init__(self, engines, policy: str = "round_robin", tracer=None,
                 roles: list[str] | None = None):
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"unknown route policy {policy!r} (known: {', '.join(ROUTE_POLICIES)})"
            )
        if not engines:
            raise ValueError("router needs at least one replica")
        self.engines = list(engines)
        self.policy = policy
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._rr = 0
        self.stats = RouterStats(routed=[0] * len(self.engines))
        self.roles = list(roles) if roles else ["mixed"] * len(self.engines)
        if len(self.roles) != len(self.engines):
            raise ValueError(
                f"{len(self.roles)} roles for {len(self.engines)} replicas"
            )
        self._admit_idx = [i for i, r in enumerate(self.roles)
                           if r in ("prefill", "mixed")]
        self._decode_idx = [i for i, r in enumerate(self.roles)
                            if r in ("decode", "mixed")]
        if not self._admit_idx:
            raise ValueError(
                "no admission target: at least one replica must have role "
                "'prefill' or 'mixed'"
            )

    # ------------------------------------------------------------- ranking
    def _load_key(self, idx: int):
        """Ascending sort key: lightest replica first.  Ties break toward
        more free blocks (paged KV headroom), then more free slots, then
        the lowest index (deterministic)."""
        ld = self.engines[idx].load()
        return (
            ld.inflight_tokens,
            -(ld.free_blocks if ld.free_blocks is not None else 0),
            -ld.free_slots,
            idx,
        )

    def rank(self, req, hits: list[int] | None = None) -> list[int]:
        """Admission-target preference order for ``req`` under the active
        policy (decode-role replicas never prefill new prompts).
        ``prefix_affinity`` probes every candidate unless the caller
        passes precomputed ``hits`` (indexed by replica)."""
        cand = self._admit_idx
        k = len(cand)
        if self.policy == "round_robin":
            return [cand[(self._rr + i) % k] for i in range(k)]
        if self.policy == "least_loaded":
            return sorted(cand, key=self._load_key)
        if hits is None:
            hits = self.probe_hits(req)
        return sorted(cand, key=lambda i: (-hits[i],) + self._load_key(i))

    def probe_hits(self, req) -> list[int]:
        """Resident-prefix hit per replica (admission targets only; a
        decode-role replica is never probed — probes are side-effect-free
        but also pointless there)."""
        return [
            self.engines[i].probe_prefix(req.prompt) if i in set(self._admit_idx)
            else 0
            for i in range(len(self.engines))
        ]

    def _ranked_by_load(self, idxs, exclude: int | None = None) -> list[int]:
        return sorted((i for i in idxs if i != exclude), key=self._load_key)

    def rank_decode(self, exclude: int | None = None) -> list[int]:
        """Decode targets (decode/mixed roles) for a prefill->decode KV
        migration, least-loaded first."""
        return self._ranked_by_load(self._decode_idx, exclude)

    def rank_refold(self, exclude: int | None = None) -> list[int]:
        """Admission targets for re-placing a preempted request's refold,
        least-loaded first (regardless of the admission policy: a refold
        is load leveling, not affinity placement)."""
        return self._ranked_by_load(self._admit_idx, exclude)

    # ------------------------------------------------------------- routing
    def route(self, req) -> int | None:
        """Place ``req``: the policy's first admitting replica, or None
        when every replica is saturated (the caller keeps it queued and
        retries with fresh state).  Each successfully routed request is
        counted exactly once, and the chosen replica's resident-prefix
        hit is recorded under every policy (probed once per replica at
        most — affinity ranking and stats share the same walk)."""
        hits = None
        if self.policy == "prefix_affinity":
            hits = self.probe_hits(req)
        order = self.rank(req, hits)
        for pos, idx in enumerate(order):
            if not self.engines[idx].can_admit(req):
                continue
            if pos > 0:
                self.stats.spills += 1
            self.stats.routed[idx] += 1
            hit = (hits[idx] if hits is not None
                   else self.engines[idx].probe_prefix(req.prompt))
            self.stats.prefix_hit_tokens += hit
            self.stats.probed_tokens += len(req.prompt)
            self.tracer.on_route(req.uid, idx, self.policy, pos, hit,
                                 len(req.prompt))
            if self.policy == "round_robin":
                self._rr = (self._admit_idx.index(idx) + 1) % len(self._admit_idx)
            return idx
        return None
