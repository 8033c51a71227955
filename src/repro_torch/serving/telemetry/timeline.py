"""Per-dispatch step timeline: what each fused step contained and cost.

The engine appends one :class:`StepRecord` per model dispatch (decode,
fused hybrid, solo prefill, boundary-packed, or whole admission prefill)
describing the dispatch's *composition* — decode batch size, prefill
chunk and bucket, token-budget fill fraction, block-pool utilization,
dispatch-ahead pipeline depth — plus analytic FLOPs/bytes from
:func:`repro_torch.analysis.roofline.dispatch_flops_bytes`, so the live run
reports the same operational-intensity accounting as the paper's Fig-1
roofline: decode-only dispatches sit deep in the memory-bound regime,
fused dispatches climb toward the ridge because the prefill chunk's
GEMMs reuse the weight stream the decode batch already paid for.

Records are built **only when telemetry is enabled** (the engine guards
on ``tracer.enabled or profiler.enabled``) and only from host-side
bookkeeping the engine already maintains — never from device arrays, so
the dispatch-ahead pipeline keeps its overlap.  ``bucket`` is the
reference's compiled chunk bucket (:func:`chunk_bucket`); the port runs
every chunk padded to ``prefill_chunk`` and records the reference's
bucket so the two timelines compare field for field.  When the sampled
:class:`~repro_torch.serving.telemetry.profiler.DispatchProfiler` fences a
dispatch, it annotates that record's ``measured_*`` fields in place.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.roofline import dispatch_flops_bytes


@dataclasses.dataclass
class StepRecord:
    """One model dispatch, as the scheduler/engine composed it."""

    replica: int
    step: int                   # engine_steps id of this dispatch
    kind: str                   # decode | fused | fused2 | solo | solo2 | prefill
    decode_batch: int           # decode lanes in the dispatch
    prefill_tokens: int         # real prefill tokens (both chunks if packed)
    bucket: int | None          # compiled chunk bucket (None: no chunk)
    bucket2: int | None         # boundary-packed second chunk's bucket
    budget: int                 # token budget the scheduler packed against
    fill: float                 # (decode + prefill) / budget
    kv_tokens: int              # KV positions attended by the decode batch
    pool_util: float | None     # paged block-pool utilization (None: dense)
    pipeline_depth: int         # dispatched-but-unobserved steps (async)
    flops: float                # analytic FLOPs for this dispatch
    bytes: float                # analytic HBM bytes for this dispatch
    oi: float                   # operational intensity = flops / bytes
    host_util: float | None = None  # host KV tier utilization (None: no tier)
    wall: float | None = None   # perf_counter at dispatch (Tracer(wall=True))
    # measured join (DispatchProfiler, sampled dispatches only): fenced
    # wall-clock seconds and the utilization it implies vs device peaks
    measured_s: float | None = None
    measured_mfu: float | None = None
    measured_mbu: float | None = None
    achieved_gbps: float | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


MIN_BUCKET = 8


def chunk_bucket(prefill_chunk: int, n_valid: int) -> int:
    """The reference scheduler's bucket of an ``n_valid``-token chunk: the
    least of ``prefill_chunk`` halved down to :data:`MIN_BUCKET` that
    holds it (``repro.serving.scheduler.chunk_buckets``)."""
    buckets = [prefill_chunk]
    while buckets[-1] > MIN_BUCKET:
        buckets.append(max(MIN_BUCKET, (buckets[-1] + 1) // 2))
    return min(b for b in buckets if b >= n_valid)


class DispatchCostModel:
    """Analytic per-dispatch cost, seeded only by the model config.

    Thin stateful wrapper over
    :func:`repro_torch.analysis.roofline.dispatch_flops_bytes` so the engine
    computes scalar host arithmetic per traced dispatch — no device
    work.
    """

    def __init__(self, cfg):
        self.cfg = cfg

    def cost(self, n_decode: int, kv_tokens: int, prefill_tokens: int = 0,
             prefill_ctx_tokens: int = 0) -> tuple[float, float]:
        return dispatch_flops_bytes(
            self.cfg, n_decode, kv_tokens, prefill_tokens, prefill_ctx_tokens
        )

    @staticmethod
    def chunk_ctx_tokens(start: int, n_valid: int) -> int:
        """Total context positions a causal chunk at offset ``start``
        attends: query i (0-based) sees ``start + i + 1`` positions."""
        return n_valid * start + n_valid * (n_valid + 1) // 2
