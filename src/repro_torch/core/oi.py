"""Operational-intensity & performance model — the paper's §III analytics.

A copy of ``repro.core.oi`` (pure Python); the port keeps its own so
that it imports nothing of ``repro``.  Beside the reference's devices it
holds ``H100-SXM``, the card the port runs on, from NVIDIA's data sheet
(3.35 TB/s HBM3, 989 TFLOP/s dense bf16, 80 GB, 700 W, 900 GB/s NVLink):
spec-sheet peaks, not a measurement.  The dispatch profiler
(``serving/telemetry/profiler.py``) divides by them by default.

Everything here is seeded ONLY by Table I device constants and model
dimensions; it reproduces Fig. 1b/c (roofline & MFU/MBU vs batch),
Fig. 7a/b (throughput & breakdown), Fig. 8 (MFU scaling) and Fig. 9
(energy efficiency).

Calibration constants (documented, not fitted per-figure):
  * ``MEM_EFF`` = 0.73 — the prototype's measured HBM utilization (§V-A).
  * ``HPU_DYN_W`` = 60 W — U55C dynamic power (TDP 150 W is never reached;
    §VI-E wall-power deltas imply ~60 W under load).
  * KV reads average over the generation phase: sequence grows from
    S_in to S_in+S_out, so mean KV length = S_in + S_out/2.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Table I (+ A100 from §III, + TPU v5e target from the brief, + the
# port's H100 SXM from NVIDIA's data sheet)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    bw: float          # HBM bytes/s
    flops: float       # peak FP16/BF16 FLOP/s
    mem: float         # HBM bytes
    tdp: float         # W
    net: float         # host link bytes/s (PCIe / NVLink / ICI per link)

    @property
    def ridge(self) -> float:
        """perf/BW ratio = OI at which the device transitions regimes."""
        return self.flops / self.bw


DEVICES: dict[str, Device] = {
    "A100": Device("A100", 1.55e12, 312e12, 40e9, 400.0, 64e9),
    "L40S": Device("L40S", 864e9, 362.1e12, 48e9, 350.0, 16e9),
    "H100-NVL": Device("H100-NVL", 3.9e12, 835.5e12, 96e9, 400.0, 900e9),
    "H100-SXM": Device("H100-SXM", 3.35e12, 989e12, 80e9, 700.0, 900e9),
    "HPU": Device("HPU", 4.9e12, 39.3e12, 144e9, 120.0, 64e9),
    "HPU-PROTO": Device("HPU-PROTO", 460e9, 0.46e12, 16e9, 150.0, 16e9),
    "TPU-V5E": Device("TPU-V5E", 819e9, 197e12, 16e9, 200.0, 50e9),
}

MEM_EFF = 0.73       # §V-A measured HBM utilization of the prototype
HPU_DYN_W = 60.0     # U55C dynamic power under load (W)
GPU_DYN_FRAC = 1.0   # GPU dynamic power fraction of TDP when busy
BYTES_PER_EL = 2     # fp16/bf16


# ---------------------------------------------------------------------------
# model workload (defaults = Llama-2 7B, the paper's benchmark model)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMShape:
    n_layers: int = 32
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    vocab: int = 32000

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def linear_params(self) -> int:
        """Per-layer linear weights (attn proj + FFN) + embeddings."""
        attn = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn += self.n_heads * self.head_dim * self.d_model
        ffn = 3 * self.d_model * self.d_ff
        return self.n_layers * (attn + ffn) + 2 * self.vocab * self.d_model

    def weight_bytes(self) -> float:
        return self.linear_params() * BYTES_PER_EL

    def kv_bytes_per_seq(self, seq: int) -> float:
        return 2 * self.n_layers * seq * self.n_kv_heads * self.head_dim * BYTES_PER_EL

    def linear_flops_per_token(self) -> float:
        return 2 * self.linear_params()

    def attn_flops_per_token(self, seq: int) -> float:
        # QK^T + PV over the cache, all heads
        return 2 * 2 * self.n_layers * self.n_heads * seq * self.head_dim


LLAMA2_7B = LMShape()


# ---------------------------------------------------------------------------
# Fig. 1b/c — OI, MFU, MBU vs batch
# ---------------------------------------------------------------------------
def gemm_oi(batch: int) -> float:
    """Weight-streaming GEMM: 2*W*b FLOPs per W*2 bytes -> OI ~ b."""
    return float(batch)


def gemv_oi(group: int = 1) -> float:
    """Decode attention: each KV byte feeds `group` query heads."""
    return float(group)


def attainable_flops(dev: Device, oi: float) -> float:
    return min(dev.flops, oi * dev.bw)


def mfu_mbu(dev: Device, oi: float) -> tuple[float, float]:
    """Model FLOPS / bandwidth utilization at a given OI (roofline ideal)."""
    perf = attainable_flops(dev, oi)
    mfu = perf / dev.flops
    mbu = (perf / oi) / dev.bw
    return mfu, mbu


# ---------------------------------------------------------------------------
# decode-step time model
# ---------------------------------------------------------------------------
def time_linear(dev: Device, m: LMShape, batch: int) -> float:
    fl = m.linear_flops_per_token() * batch
    by = m.weight_bytes()
    return max(fl / dev.flops, by / (dev.bw * MEM_EFF))


def time_attention(dev: Device, m: LMShape, batch: int, seq: int, n_dev: int = 1) -> float:
    by = m.kv_bytes_per_seq(seq) * batch / n_dev
    fl = m.attn_flops_per_token(seq) * batch / n_dev
    return max(fl / dev.flops, by / (dev.bw * MEM_EFF))


def boundary_bytes_per_step(m: LMShape, batch: int) -> float:
    """Per-token Q/K/V vectors + attention output (the PCIe transfer)."""
    per_tok = (m.n_heads + 2 * m.n_kv_heads + m.n_heads) * m.head_dim * BYTES_PER_EL
    return m.n_layers * per_tok * batch


def step_time_gpu_only(gpu: Device, m: LMShape, batch: int, seq: int) -> dict:
    tl = time_linear(gpu, m, batch)
    ta = time_attention(gpu, m, batch, seq)
    return {"linear": tl, "attention": ta, "network": 0.0, "total": tl + ta}


def step_time_hetero(
    gpu: Device,
    hpu: Device,
    m: LMShape,
    batch: int,
    seq: int,
    n_hpu: int = 4,
    pipelined: bool = True,
) -> dict:
    tl = time_linear(gpu, m, batch)
    ta = time_attention(hpu, m, batch, seq, n_dev=n_hpu)
    tn = boundary_bytes_per_step(m, batch) / hpu.net
    if pipelined:
        # staggered sub-batches (Fig. 3): network and the shorter stage hide
        total = max(tl, ta) + tn
    else:
        total = tl + ta + tn
    return {"linear": tl, "attention": ta, "network": tn, "total": total}


def max_batch_gpu_only(gpu: Device, m: LMShape, seq: int) -> int:
    """OOM boundary (§VI-B): weights + activations margin + KV caches."""
    free = gpu.mem * 0.95 - m.weight_bytes()
    return max(int(free / m.kv_bytes_per_seq(seq)), 0)


def max_batch_per_hpu(hpu: Device, m: LMShape, seq: int) -> int:
    """The card holds ONLY KV (no weights/activations) -> full HBM usable."""
    return max(int(hpu.mem / m.kv_bytes_per_seq(seq)), 0)


# ---------------------------------------------------------------------------
# energy model (Fig. 9)
# ---------------------------------------------------------------------------
def energy_per_step(gpu: Device, times: dict, n_hpu: int = 0, hpu_dyn: float = HPU_DYN_W) -> float:
    """Joules per decode step: dynamic power x busy time per device."""
    total = times["total"]
    gpu_busy = times["linear"] + (times["attention"] if n_hpu == 0 else 0.0)
    e = gpu.tdp * GPU_DYN_FRAC * min(gpu_busy, total)
    if n_hpu:
        e += n_hpu * hpu_dyn * min(times["attention"], total)
    return e


def tokens_per_joule(batch: int, times: dict, gpu: Device, n_hpu: int = 0) -> float:
    return batch / energy_per_step(gpu, times, n_hpu) if times["total"] else 0.0


# ---------------------------------------------------------------------------
# end-to-end MFU (Fig. 8)
# ---------------------------------------------------------------------------
def mfu_end_to_end(gpu: Device, m: LMShape, batch: int, seq: int, times: dict) -> float:
    useful = (m.linear_flops_per_token() + m.attn_flops_per_token(seq)) * batch
    return useful / (times["total"] * gpu.flops)
