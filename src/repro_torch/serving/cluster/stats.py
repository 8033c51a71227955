"""Cluster-level statistics: per-replica rows + aggregate scale-out view.

Counterpart of ``repro.serving.cluster.stats``.

The paper's scale-out claim is about *aggregate* serving capacity — HPU
cards added to a node raise total KV residency and therefore total
decode throughput.  The cluster analogue reported here:

* ``tokens_per_round`` — generated tokens per cluster round (one round
  steps every replica once), the machine-independent scaling metric;
* per-replica ``utilization`` — the fraction of each replica's
  slot-rounds that produced a token (idle replicas drag this down);
* ``load_imbalance`` — max/mean of per-replica generated tokens: 1.0 is
  a perfectly level cluster, and a bad router shows up here first;
* ``mean_queue_wait_rounds`` — rounds a request spent in the *global*
  queue before any replica could admit it (per-replica TTFT is measured
  by each engine separately);
* ``mean_ttft_rounds`` — submit round to first-token round, the
  *end-to-end* TTFT clock: unlike each engine's step-clock TTFT it
  includes the global queue wait, so it is the metric disaggregated
  (prefill/decode role) layouts are judged on;
* ``migrations`` / ``refold_moves`` — cross-replica KV handoffs (the
  disaggregated prefill->decode path) and router-driven refold
  re-placements.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.engine import EngineStats
from repro_torch.serving.telemetry import percentile


@dataclasses.dataclass
class ReplicaStats:
    """One replica's contribution, as the cluster saw it."""

    replica: int
    routed: int                 # requests the router placed here
    n_slots: int
    engine: EngineStats         # the replica engine's own counters
    role: str = "mixed"         # disaggregated serving role

    def utilization(self, rounds: int) -> float:
        """Generated tokens per slot-round offered to this replica."""
        return self.engine.generated / max(rounds * self.n_slots, 1)

    @property
    def routed_share(self) -> float:
        """Routed requests per token generated (0.0 before any output)."""
        return self.routed / max(self.engine.generated, 1)


@dataclasses.dataclass
class ClusterStats:
    rounds: int
    replicas: list[ReplicaStats]
    spills: int                 # requests admitted off their first choice
    prefix_hit_tokens: int      # resident-prefix tokens at routing time
    probed_tokens: int          # total prompt tokens routed
    queue_wait_sum: int         # rounds spent in the global queue
    queue_wait_count: int
    migrations: int = 0         # prefill->decode KV handoffs
    refold_moves: int = 0       # refolds re-placed off their home replica
    # submit round -> first-token round per request (end-to-end TTFT)
    ttft_rounds_samples: list[int] = dataclasses.field(default_factory=list)

    @property
    def generated(self) -> int:
        return sum(r.engine.generated for r in self.replicas)

    @property
    def mean_ttft_rounds(self) -> float:
        """Mean end-to-end TTFT in cluster rounds (includes the global
        queue wait; see module docstring)."""
        return (sum(self.ttft_rounds_samples)
                / max(len(self.ttft_rounds_samples), 1))

    def ttft_rounds_percentile(self, p: float) -> float:
        return percentile(self.ttft_rounds_samples, p)

    @property
    def preemptions(self) -> int:
        return sum(r.engine.preemptions for r in self.replicas)

    @property
    def kv_spills(self) -> int:
        """KV blocks spilled to the host tier across replicas (distinct
        from ``spills``, which counts router spill-over placements)."""
        return sum(r.engine.spills for r in self.replicas)

    @property
    def kv_rehydrations(self) -> int:
        return sum(r.engine.rehydrations for r in self.replicas)

    @property
    def tokens_per_round(self) -> float:
        return self.generated / max(self.rounds, 1)

    @property
    def mean_queue_wait_rounds(self) -> float:
        return self.queue_wait_sum / max(self.queue_wait_count, 1)

    @property
    def mean_ttft_steps(self) -> float:
        """Request-weighted mean TTFT across replicas, in engine steps."""
        total = sum(r.engine.ttft_steps_sum for r in self.replicas)
        count = sum(r.engine.ttft_count for r in self.replicas)
        return total / max(count, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of routed prompt tokens already resident on the
        chosen replica (the prefix-affinity win metric)."""
        return self.prefix_hit_tokens / max(self.probed_tokens, 1)

    @property
    def load_imbalance(self) -> float:
        """max/mean of per-replica generated tokens (1.0 = level)."""
        gen = [r.engine.generated for r in self.replicas]
        if not gen:
            return 1.0
        mean = sum(gen) / len(gen)
        return max(gen) / mean if mean > 0 else 1.0

    def ttft_percentile(self, p: float) -> float:
        """Exact TTFT percentile over all replicas' raw samples."""
        return percentile(
            [s for r in self.replicas for s in r.engine.ttft_samples], p
        )

    @property
    def ttft_p50_steps(self) -> float:
        return self.ttft_percentile(50)

    @property
    def ttft_p99_steps(self) -> float:
        return self.ttft_percentile(99)

    def per_token_percentile(self, p: float) -> float:
        """Exact decode per-token-latency percentile across replicas."""
        return percentile(
            [s for r in self.replicas for s in r.engine.per_token_samples], p
        )

    def summary(self) -> str:
        per = " ".join(
            f"r{r.replica}[{r.role[0].upper()}]:routed={r.routed},"
            f"gen={r.engine.generated},"
            f"util={r.utilization(self.rounds):.2f}"
            for r in self.replicas
        )
        extra = ""
        if self.migrations or self.refold_moves:
            extra = (f" migrations={self.migrations}"
                     f" refold_moves={self.refold_moves}")
        return (
            f"rounds={self.rounds} generated={self.generated} "
            f"tokens/round={self.tokens_per_round:.2f} "
            f"ttft={self.mean_ttft_steps:.1f} "
            f"ttft_rounds={self.mean_ttft_rounds:.1f} "
            f"queue_wait={self.mean_queue_wait_rounds:.1f} "
            f"imbalance={self.load_imbalance:.2f} spills={self.spills} "
            f"prefix_hit_rate={self.prefix_hit_rate:.2f}{extra} | {per}"
        )
