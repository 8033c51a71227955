"""Metrics registry: counters, gauges, and exact-percentile histograms.

A copy of ``repro.serving.telemetry.metrics`` without
``cluster_registry``, which comes with the cluster (ROADMAP.md queue 1
item 5).

``EngineStats`` stays the engine's hot-path store (cheap int bumps on a
dataclass), but everything *reported* — the serve CLI printout, the
``--metrics-out`` JSON dump —
goes through a :class:`MetricsRegistry` built from it, so there is one
naming scheme and one percentile definition everywhere.
``tests/test_torch_telemetry.py`` holds its snapshot equal to the
reference's.

Histograms keep raw samples (serving runs here are O(requests), not
O(tokens), samples) so ``p50/p90/p99`` are exact nearest-rank
percentiles, not bucket interpolations — the satellite requirement that
a measured p99 TTFT be a TTFT some request actually saw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any


def percentile(samples, p: float) -> float:
    """Exact nearest-rank percentile over raw samples.

    Edge cases are pinned by ``tests/test_observatory.py``: no samples
    -> 0.0 (a snapshot of an empty histogram must not error), one sample
    -> that sample for every ``p``, and ``p`` outside [0, 100] clamps to
    the min/max sample instead of indexing out of range.
    """
    s = sorted(samples)
    if not s:
        return 0.0
    p = min(max(p, 0.0), 100.0)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[min(rank, len(s)) - 1])


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Raw-sample histogram with exact percentiles."""

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def extend(self, vs) -> None:
        self.samples.extend(float(v) for v in vs)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    @property
    def mean(self) -> float:
        return self.sum / max(self.count, 1)

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)


class MetricsRegistry:
    """Flat name -> metric map with a JSON-ready snapshot.

    Histogram ``name`` expands in the snapshot to ``name_count``,
    ``name_mean``, ``name_p50``, ``name_p90``, ``name_p99``.
    """

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind()
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_mean"] = m.mean
                for p in (50, 90, 99):
                    out[f"{name}_p{p}"] = m.percentile(p)
            else:
                out[name] = float(m.value)
        return out

    def render(self, prefix: str = "") -> str:
        return " ".join(f"{prefix}{k}={v:.4g}"
                        for k, v in self.snapshot().items())


# --------------------------------------------------------------- builders
_ENGINE_COUNTERS = (
    "prefills", "prefill_chunks", "boundary_packs", "decode_steps",
    "engine_steps", "generated", "preemptions", "victim_drains",
    "spills", "rehydrations", "migrations_out", "migrations_in",
    "spec_steps", "draft_steps", "drafted_tokens", "accepted_tokens",
)


def engine_registry(stats, pool_stats=None) -> MetricsRegistry:
    """The single reporting view over one engine's ``EngineStats`` (plus
    its ``PoolStats`` when serving from the paged cache)."""
    reg = MetricsRegistry()
    for name in _ENGINE_COUNTERS:
        reg.counter(name).inc(getattr(stats, name))
    reg.gauge("peak_active").set(stats.peak_active)
    reg.gauge("tokens_per_step").set(stats.tokens_per_step)
    reg.gauge("mean_ttft_steps").set(stats.mean_ttft_steps)
    reg.histogram("ttft_steps").extend(stats.ttft_samples)
    reg.histogram("per_token_steps").extend(stats.per_token_samples)
    # speculative decoding: overall acceptance ratio plus the per-window
    # acceptance-fraction distribution (one sample per observed verify row)
    reg.gauge("spec_accept_rate").set(stats.acceptance_rate)
    reg.histogram("spec_accept_frac").extend(
        getattr(stats, "spec_accept_samples", ())
    )
    if pool_stats is not None:
        for name in ("allocs", "frees", "hash_hits", "cow_copies",
                     "spills", "rehydrates", "host_evictions"):
            reg.counter(f"pool_{name}").inc(getattr(pool_stats, name))
        reg.gauge("pool_peak_in_use").set(pool_stats.peak_in_use)
        reg.gauge("pool_host_peak_in_use").set(pool_stats.host_peak_in_use)
    return reg

