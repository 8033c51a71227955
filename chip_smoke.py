"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds every kernel in ``src/repro_torch/kernels/csrc/`` with nvcc
   (one process per source, in parallel) and prints the build time and,
   per kernel, ptxas's registers, shared memory and spills.
3. Kernel phase: each kernel variant against its plain PyTorch version
   at the main paths' shapes, with its device time (the calls queued
   behind a spin kernel, so events time the device and not the host)
   beside the plain version's,
   a PyTorch yardstick on the same work (``scaled_dot_product_attention``;
   for the paged kernel ``gather_paged_cache`` then SDPA, since no single
   call computes paged attention; for the fp8/int8 variants the
   dequantization too; never used by the port) and the least time the
   card could take.  Every prefill case also runs with ``q_offset`` as a
   ``(1,)`` int32 device tensor (what a captured graph passes), which must
   give the int form's bits; the chunk rows are timed in that form too.  Thirteen rows: decode (split across CTAs, partials
   merged by a second kernel); prefill unscaled at a whole prompt and at
   the hybrid chunk shape (32 queries at q_offset 192 against the
   1024-position staging stripe, after the chunk edge cases), int8 and
   fp8 K/V, and f32 queries over f32 K/V (float32 mode's CUDA-core
   kernel); paged unscaled, fp8 and int8 pools (split across CTAs like
   the decode); the speculative draft's decode and prefill chunk at its
   own heads (Hkv 2, G 2, D 16); paged bf16 and fp8 pools at block size
   128.  The paged variants are also checked with f32 queries,
   with a ``starts`` window + lse, with NaN in null block 0 and past each
   row's length (never read: equal to the plain version on zeros there)
   and with every window empty (the cold launch of a step with nothing
   spilled: out 0, lse <= -1e30).  The scaled and f32 prefill variants
   are on no serving path (the reference's quantized pools prefill into
   the bf16 staging cache; float32 mode runs in the reference checks):
   kernel level only.
4. Serve phase: full-width llama3.2-1b with seeded random weights through
   ``repro_torch.launch.serve``, seventeen paths, every dispatch kind of each
   one captured CUDA graph (the engine's default on the card; the counts
   of each kind's calls, replays and capture time are printed), each with
   every launch counter zeroed before its async run and read after it:
   a. dense cache, decode-only schedule (slice 1's main path);
   b. paged cache, hybrid chunked-prefill schedule, a pool of 385 blocks
      (6144 positions for up to 16 x 576: admission waits on blocks);
   c. paged-tiered (slice 3's main path): hybrid schedule, fp8 pool of
      129 blocks (2048 positions: the pool must spill) and a host tier
      of 512 blocks;
   d. the same tier with an int8 pool on the decode-only schedule;
   e. dense-spec (slice 6's main path): a with ``--spec-depth 2`` and the
      default reduced draft, on a's first 32 requests;
   f. paged-hybrid-spec: b with ``--spec-depth 2``, on b's first 32;
   g. target-draft: a's first 16 requests at depth 2 with the target as
      its own draft (its cache prefilled whole, the draft's in chunks);
   h. target-draft-hybrid: the same on the dense hybrid schedule, where
      both caches are filled by the same chunk calls: acceptance >= 0.99;
   i. rag: b's pool with the ``rag`` open-loop workload (64 requests at
      0.5 per round, ten shared documents): prefix hits must occur;
   j. chat-fan: c's tiered pool with ``chat-fan`` (64 requests, groups of
      4 sharing a prefix): prefix hits, COW copies, spills, rehydrations;
   k. agentic: a's dense cache with ``agentic`` (16 sessions x 3 turns,
      each turn resubmitted with the prior output as a grown prefix): 32
      resubmissions;
   l. the cluster tier, two replicas on the one card sharing the weights,
      each path async with its launches counted over both replicas and its
      tokens held to its single-engine path's by the tiered criterion
      (every first token equal, >= 60% of all): cluster-affinity and
      cluster-round-robin, i's rag traffic routed by ``--route
      prefix_affinity`` and ``round_robin`` (the router's hit rate of
      each); disagg, b's pool as ``--role-map 1p+1d`` (KV blocks migrate
      from the prefill replica to the decode one: none lost);
      disagg-tiered, the same on c's fp8 pools with host tiers;
   m. sub-batches: a with ``--sub-batches 2`` (two sub-batches of 8 rows,
      each on its own CUDA stream inside the decode graph), async, eager
      and sync; n. dense-8: a at ``--slots 8``, whose decode batch is one
      sub-batch's 8 rows: m's tokens must be n's exactly (a's 16-row
      GEMMs sum one product in another order, so m's agreement with a is
      printed only); then wall ms per engine step of m against
      ``--sub-batches 1`` in turns, and a profile of its decode steps
      (graphs and eager): kernels per stream id and how long kernels ran
      at once.
   Paths a-k, m and n run async (dispatch-ahead) and then sync; the greedy tokens must
   be identical, each kernel row must have launched once per layer of
   every prefill, chunk and decode step of its path (twice per layer of a
   decode step on the tiered paths: hot and cold windows; k + 1 times per
   layer of a speculative window, the target's and the draft's layers
   counted apart by head shape), and the paged paths' pools must drain;
   the tiered paths must spill and not preempt; the speculative paths'
   tokens must equal their non-speculative path's.  Paths a, b, c and e
   (the profiled ones) also run eagerly (``--graphs off``) in the same
   call: graph and eager greedy tokens must be identical; tok/s and wall
   ms per engine step of both.
   Then the observatory: path b traced (``--trace`` to a file in the
   temporary directory, wall stamps on) and profiled (``--profile 8``:
   every eighth dispatch fenced on the card) against the same run
   untraced: the trace validates and holds a finished, well-formed span
   tree per request; tokens, stats and launch counts are the untraced
   run's; no dispatch that captured a graph is sampled; no sample's
   measured MFU or MBU (against the H100 SXM's peaks) exceeds 1.05.  It
   prints per dispatch kind the samples, median measured ms, MFU, MBU and
   GB/s, and tok/s traced vs untraced.
5. Profiles (torch.profiler) of steady async steps on paths a, b, c and
   e, with graphs and eagerly, for where the time goes: wall and device
   busy ms per step, device ops per step, host launches per step (graph
   launches and kernel launches apart) and every port kernel's time and
   launches per step (the split kernels and the combine kernel apart); on path c
   also the hot and the cold paged call of one layer on the profiled
   state: device time (queued behind a spin kernel) and host time per
   call.
6. A small-input check: reduced llama3.2-1b in float32 through the
   kernels on the GPU against the plain path on the CPU, same weights:
   prefill and decode on the dense cache, chunked ``prefill_step`` and
   ``paged_decode_step`` on the paged pool — bf16, fp8 and int8 pools,
   the quantized ones also with their first blocks spilled to the host
   tier.
7. A preemption check: reduced llama3.2-1b on a pool too small for both
   sequences, on the GPU, async against sync (greedy tokens) and both
   against the CPU engine (step clock), decode-only and hybrid.
8. A host-tier check: the same model on the GPU with a host tier, async
   and sync: live spills instead of preemption with the unspilled run's
   tokens, a freed prefix re-hydrated with the same continuation, a
   spilled slot reused by another prompt, and the step clock of the CPU
   engine.
9. A speculative check: reduced float32 engines at depth 2 on the GPU
   (async, sync) against the CPU, {dense, paged} x {decode-only, hybrid},
   a mismatched draft and the target as draft: tokens (also those of the
   plain run) and step clock equal; ``verify_step`` / ``paged_verify_step``
   logits GPU vs CPU, with windows past ``max_seq`` and past the table.
10. Block size 128: a reduced serve at ``--cache paged --block-size 128``
   (launches exact at that shape) and reduced float32 engines on the GPU
   against the CPU.
11. A temperature check under graphs: the reduced model's logits for 16
   prompts sampled (temperature 1, top-k 8) by a captured program, 512
   replays against 512 eager draws: consecutive replays draw different
   tokens, each set's counts fit the exact distribution and the two sets
   fit each other (chi-square bounds stated there); then a temperature
   serve through the graphs, plain and speculative.
12. A migration check: a request exported from one reduced engine and
   imported into another (bf16 pool; fp8 pool with its scale pools): the
   gathered blocks equal the source's and the landed blocks the payload,
   by ``torch.equal`` on their bytes; the unmigrated run's tokens.
13. A cluster check: reduced float32 two-replica clusters (1P+1D paged
   hybrid, 1P+1D dense, prefix-affinity paged hybrid), async and sync,
   on the card under graphs against the CPU: tokens, ``ClusterStats`` and
   ``RouterStats`` equal.
14. A sub-batch check: ``sub_batches=2`` under graphs against eager
   and against a plain engine whose batch is one sub-batch (bf16; tokens,
   stats, the decode kernel twice per layer and step), and float32 on the
   card against the CPU.

Any failure raises (non-zero exit).  The line before the last is a JSON
object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import heads as kernel_heads  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpaged  # noqa: E402
from repro_torch.kernels import prefill_attention as kpre  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.cluster import Cluster  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import device as pdev  # noqa: E402
from repro_torch.serving.programs import Program  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig, sample_on_device  # noqa: E402
from repro_torch.serving.telemetry import build_request_trees, validate_trace  # noqa: E402
from repro_torch.serving.workload import build_workload  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_8BIT_OPS = 1979e12   # fp8 flop/s and int8 op/s
PEAK_F32_FLOPS = 67e12    # CUDA cores, outside the tensor cores
L2_BYTES = 50 * 2**20
BF16_TOL = 2e-2           # bf16 output, as tests/test_kernels.py holds the Pallas kernels
F32_TOL = 1e-4            # f32 queries: the kernels' f32 sums in another order
SERVE_FLAGS = ["--arch", "llama3.2-1b", "--requests", "64", "--slots", "16",
               "--max-seq", "1024", "--max-new", "64", "--workload", "random",
               "--workload-seed", "0", "--seed", "0", "--device", "cuda"]
PAGED_FLAGS = ["--cache", "paged", "--schedule", "hybrid", "--blocks", "385"]
# 128 usable blocks against the ~185 the paged-hybrid run holds at its peak
TIER = ["--host-blocks", "512", "--blocks", "129"]
TIERED_FLAGS = ["--cache", "paged", "--schedule", "hybrid", "--kv-dtype", "fp8", *TIER]
TIERED_INT8_FLAGS = ["--cache", "paged", "--schedule", "decode-only", "--kv-dtype", "int8",
                     *TIER]
CHUNK_SQ, CHUNK_OFFSET = 32, 192       # a hybrid chunk (--prefill-chunk 32) mid-prompt
# the open-loop workloads at full width: shared documents on the paged
# pool, shared chat prefixes on the tiered pool, grown agentic sessions
RAG_FLAGS = PAGED_FLAGS + ["--workload", "rag", "--arrival-rate", "0.5"]
CHAT_FAN_FLAGS = TIERED_FLAGS + ["--workload", "chat-fan", "--fan", "4"]
AGENTIC_FLAGS = ["--workload", "agentic", "--requests", "16", "--turns", "3"]
# the cluster tier (two replicas on the one card, sharing the weights):
# rag's traffic routed by prefix affinity and by round robin; a 1P+1D
# disaggregated layout on paged-hybrid's and on paged-tiered's pools
CLUSTER_FLAGS = ["--replicas", "2"]
AFFINITY_FLAGS = CLUSTER_FLAGS + ["--route", "prefix_affinity"] + RAG_FLAGS
ROUND_ROBIN_FLAGS = CLUSTER_FLAGS + ["--route", "round_robin"] + RAG_FLAGS
DISAGG_FLAGS = CLUSTER_FLAGS + ["--role-map", "1p+1d"] + PAGED_FLAGS
DISAGG_TIERED_FLAGS = CLUSTER_FLAGS + ["--role-map", "1p+1d"] + TIERED_FLAGS
SUB_BATCH_FLAGS = ["--sub-batches", "2"]
TOKEN_FLOOR = 0.6         # the tiered criterion: every first token equal, >= 60% of all
PROFILE_EVERY = 8
MAX_SHARE = 1.05          # a measured MFU or MBU above this is a fault, not a reading
SPEC_DEPTH = 2
# the speculative paths serve the first half of the base paths' requests
SPEC_FLAGS = ["--spec-depth", str(SPEC_DEPTH), "--requests", "32"]
PORT_KERNELS = ("decode_split_mma_kernel", "decode_split_fma_kernel", "span_combine_kernel",
                "flash_prefill_mma_kernel", "flash_prefill_fma_kernel",
                "paged_split_mma_kernel", "paged_split_fma_kernel")
LENGTHS = [1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700, 900, 1000, 1023]


def _time_ms(fns, iters: int = 30) -> float:
    """Mean device time of one call, cycling through ``fns`` (one per
    input copy, so inputs larger than L2 are read cold)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fns, iters: int = 30) -> float:
    """Device time of one call, cycling through ``fns``: the calls are
    queued behind a spin kernel (``torch.cuda._sleep``), so the events
    around them time the device alone and not the host's dispatch.  The
    spin doubles until the host had queued every call before the device
    reached the first."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    while cycles < 1 << 34:
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("_device_ms: the host could not queue the calls ahead of the device")


def _times(kernel, plain, library) -> dict:
    """A kernel row's times per call: ``ms``, ``plain_ms`` and
    ``library_ms`` are device time (:func:`_device_ms`, gaps between a
    call's kernels included); ``event_ms`` is
    the kernel wrapper's CUDA-event time over back-to-back calls, which
    measures the host's dispatch instead once the kernel is faster than
    the wrapper's Python (earlier PRs' kernel times were event times)."""
    return {"ms": _device_ms(kernel), "event_ms": _time_ms(kernel),
            "plain_ms": _device_ms(plain, 10), "library_ms": _device_ms(library)}


def _bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------- kernel phase
def decode_phase(dev, draft: bool = False) -> dict:
    """llama3.2-1b decode attention at 16 slots, max_seq 1024, bf16;
    ``draft``: at the shape of its ``--spec-depth`` draft (reduced
    llama3.2-1b: Hkv 2, G 2, D 16, padded to 32 in the tensor-core
    kernel), which decodes k + 1 times per speculative step."""
    B, S, Hkv, G, D = (16, 1024, 2, 2, 16) if draft else (16, 1024, 8, 4, 64)
    name = "decode_attention[draft]" if draft else "decode_attention"
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    cache_bytes = 2 * B * S * Hkv * D * 2
    n_copies = max(1, math.ceil(2 * L2_BYTES / cache_bytes))
    sets = []
    for _ in range(n_copies):
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
        sets.append((q, k, v))
    q, k, v = sets[0]
    out = ops.decode_attention(q, k, v, lengths)
    exp = kdec.plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    if not err <= BF16_TOL:
        raise AssertionError(f"{name} kernel vs plain: max err {err}")

    pos = torch.arange(S, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]            # (B,1,1,S)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.view(B, Hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_out = library(q, k, v).view(B, Hkv * G, D)
    lib_err = _max_err(lib_out, exp)
    live = int(lengths.clamp(max=S).sum())
    nbytes = 2 * live * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4
    flops = 4 * live * Hkv * G * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "decode_attention", "variant": "unscaled",
        "heads": kernel_heads(Hkv, G, D), "route": "cuda", "source": kdec.SOURCE,
        "replaces": kdec.REPLACES, "max_abs_err": err, "tol": BF16_TOL,
        **_times([lambda s=s: ops.decode_attention(*s, lengths) for s in sets],
                 [lambda s=s: kdec.plain(*s, lengths) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 lengths={lengths.tolist()} "
                 f"split={kdec.plan_split(S, B * Hkv, kdec.sm_count(dev))}",
    }


def _quantize(x: torch.Tensor, kv: str | None):
    """``(payload, scale)`` of ``x`` in the pool's storage: bf16 and no
    scale for the unscaled kernels, fp8/int8 with f32 scales else."""
    if kv is None:
        return x.bfloat16(), None
    return ref.kv_quantize(x, kv)


def _row_name(kernel: str, kv: str | None) -> str:
    return kernel if kv is None else f"{kernel}[{kv}]"


def _same_at_tensor_offset(out, q, k, v, off: int, ks=None, vs=None) -> None:
    """The flash kernel with ``q_offset`` read from device memory (a
    ``(1,)`` int32 tensor, as a captured graph passes it) must give the
    bits of its int form ``out``."""
    dev_off = torch.tensor([off], dtype=torch.int32, device=q.device)
    got = ops.flash_attention(q, k, v, q_offset=dev_off, k_scale=ks, v_scale=vs)
    if not torch.equal(got, out):
        raise AssertionError(f"prefill_attention at a tensor q_offset {off} differs from the "
                             f"int form (Sq={q.shape[1]}, K/V {k.dtype}): max err "
                             f"{_max_err(got, out)}")


def prefill_phase(dev, kv: str | None = None) -> dict:
    """llama3.2-1b prefill attention (Hq 32, Hkv 8, D 64, bf16 queries, B 1)
    at odd prompt lengths, q_offset 0 (the main path) and 17; ``kv``:
    int8/fp8 K/V with (B, Sk, Hkv) f32 scales (the scaled variant)."""
    Hq, Hkv, D = 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    cases, timed = [], None
    for sq, off in ((37, 0), (37, 17), (509, 17), (509, 0)):
        sk = sq + off
        q = torch.randn(1, sq, Hq, D, generator=gen, device=dev).bfloat16()
        k, ks = _quantize(torch.randn(1, sk, Hkv, D, generator=gen, device=dev), kv)
        v, vs = _quantize(torch.randn(1, sk, Hkv, D, generator=gen, device=dev), kv)
        out = ops.flash_attention(q, k, v, q_offset=off, k_scale=ks, v_scale=vs)
        exp = kpre.plain(q, k, v, q_offset=off, k_scale=ks, v_scale=vs)
        _same_at_tensor_offset(out, q, k, v, off, ks, vs)
        torch.cuda.synchronize()
        err = _max_err(out, exp)
        if not err <= BF16_TOL:
            raise AssertionError(f"{_row_name('prefill_attention', kv)} kernel vs plain at "
                                 f"Sq={sq} q_offset={off}: max err {err}")
        cases.append({"sq": sq, "sk": sk, "q_offset": off, "max_abs_err": err})
        timed = (q, k, v, ks, vs, sq, sk, off)
    q, k, v, ks, vs, sq, sk, off = timed      # the main path's case: q_offset 0, Sq 509

    def library():
        kd = k if kv is None else ref.kv_dequantize(k, ks)
        vd = v if kv is None else ref.kv_dequantize(v, vs)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    exp = kpre.plain(q, k, v, k_scale=ks, v_scale=vs)
    lib_err = _max_err(library().transpose(1, 2), exp)
    pairs = sum(min(sk, off + i + 1) for i in range(sq))    # visible (q, k) pairs
    flops = 4 * pairs * Hq * D
    scale_bytes = 0 if kv is None else 2 * ks.numel() * 4
    nbytes = 2 * 2 * q.numel() + k.numel() * k.element_size() * 2 + scale_bytes
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS if kv is None
                                else PEAK_8BIT_OPS)
    return {
        "name": _row_name("prefill_attention", kv), "kernel": "prefill_attention",
        "variant": kv or "unscaled", "heads": kernel_heads(Hkv, Hq // Hkv, D),
        "route": "cuda", "source": kpre.SOURCE,
        "replaces": kpre.REPLACES,
        "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": BF16_TOL,
        **_times([lambda: ops.flash_attention(q, k, v, k_scale=ks, v_scale=vs)],
                 [lambda: kpre.plain(q, k, v, k_scale=ks, v_scale=vs)], [library]),
        "library": "scaled_dot_product_attention" if kv is None
                   else "ref.kv_dequantize (k, v) + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "f32_fma_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "shape": f"B=1 Sq=Sk={sq} Hq={Hq} Hkv={Hkv} D={D} q bf16, K/V {kv or 'bf16'} "
                 "causal q_offset=0",
        "cases": cases,
    }


def prefill_chunk_phase(dev, draft: bool = False) -> dict:
    """llama3.2-1b prefill attention at the hybrid schedule's chunk shape
    (``--prefill-chunk 32``): 32 bf16 queries at q_offset 192 against the
    1024-position staging stripe (B 1, Hq 32, Hkv 8, D 64, causal), after
    the chunk's edge cases Sq in {1, 5, 32} x q_offset in {0, 17, 192,
    991}.  ``draft``: the same at the ``--spec-depth`` draft's heads (Hq
    4, Hkv 2, D 16), whose cache is prefilled in such chunks against its
    1024-position stripe.  Yardstick: one SDPA call over ``k[:, :q_offset
    + Sq]`` with a lower-right causal mask.  The bound counts the keys the
    chunk sees."""
    Hq, Hkv, D, S = (4, 2, 16, 1024) if draft else (32, 8, 64, 1024)
    name = "prefill_attention[draft-chunk]" if draft else "prefill_attention[chunk]"
    sq, off = CHUNK_SQ, CHUNK_OFFSET
    gen = torch.Generator(device=dev).manual_seed(3)
    n_copies = max(1, math.ceil(2 * L2_BYTES / (2 * S * Hkv * D * 2)))
    sets = [tuple(torch.randn(1, *shape, generator=gen, device=dev).bfloat16()
                  for shape in ((sq, Hq, D), (S, Hkv, D), (S, Hkv, D)))
            for _ in range(n_copies)]
    _, k, v = sets[0]
    cases = []
    for n in (1, 5, 32):
        for o in (0, 17, 192, 991):
            q = torch.randn(1, n, Hq, D, generator=gen, device=dev).bfloat16()
            out = ops.flash_attention(q, k, v, q_offset=o)
            exp = kpre.plain(q, k, v, q_offset=o)
            _same_at_tensor_offset(out, q, k, v, o)
            torch.cuda.synchronize()
            err = _max_err(out, exp)
            if not err <= BF16_TOL:
                raise AssertionError(f"{name} kernel vs plain at Sq={n} "
                                     f"q_offset={o}: max err {err}")
            cases.append({"sq": n, "q_offset": o, "max_abs_err": err})
    q, k, v = sets[0]
    out = ops.flash_attention(q, k, v, q_offset=off)
    exp = kpre.plain(q, k, v, q_offset=off)
    _same_at_tensor_offset(out, q, k, v, off)
    err = _max_err(out, exp)
    if not err <= BF16_TOL:
        raise AssertionError(f"{name} kernel vs plain: max err {err}")
    mask = torch.ones(sq, off + sq, dtype=torch.bool, device=dev).tril(diagonal=off)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :off + sq].transpose(1, 2),
            v[:, :off + sq].transpose(1, 2), attn_mask=mask, enable_gqa=True)

    lib_err = _max_err(library(q, k, v).transpose(1, 2), exp)
    dev_off = torch.tensor([off], dtype=torch.int32, device=dev)
    pairs = sum(min(S, off + i + 1) for i in range(sq))
    flops = 4 * pairs * Hq * D
    nbytes = 2 * 2 * q.numel() + 2 * (off + sq) * Hkv * D * 2
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "prefill_attention",
        "variant": "unscaled", "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda",
        "source": kpre.SOURCE,
        "replaces": kpre.REPLACES, "max_abs_err": max([err] + [c["max_abs_err"] for c in cases]),
        "tol": BF16_TOL,
        **_times([lambda s=s: ops.flash_attention(*s, q_offset=off) for s in sets],
                 [lambda s=s: kpre.plain(*s, q_offset=off) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        # the form the captured graphs launch: q_offset read from device memory
        "device_offset_ms": _device_ms([lambda s=s: ops.flash_attention(*s, q_offset=dev_off)
                                        for s in sets]),
        "library": "scaled_dot_product_attention over k[:, :q_offset + Sq], lower-right "
                   "causal mask",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B=1 Sq={sq} q_offset={off} Sk={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
                 + ("(the draft's prefill chunk against its cache stripe)" if draft
                    else "(the hybrid chunk against the staging stripe)"),
        "cases": cases,
    }


def prefill_f32_phase(dev) -> dict:
    """float32 mode's flash prefill: f32 queries over f32 K/V (the
    CUDA-core kernel) at the whole-prompt shape, llama3.2-1b's heads (Hq
    32, Hkv 8, D 64), B 1, Sq = Sk = 509, causal.  Its bound takes the f32
    flops at the CUDA cores' peak: float32 mode's tolerances rule out
    bf16 and TF32 operands.  Yardstick: one SDPA call on the same f32
    tensors (TF32 off, PyTorch's default for matrix products)."""
    Hq, Hkv, D, sq = 32, 8, 64, 509
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(1, sq, h, D, generator=gen, device=dev) for h in (Hq, Hkv, Hkv))
    out = ops.flash_attention(q, k, v)
    exp = kpre.plain(q, k, v)
    _same_at_tensor_offset(out, q, k, v, 0)
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    if not (out.dtype == torch.float32 and err <= F32_TOL):
        raise AssertionError(f"prefill_attention[f32] kernel vs plain: max err {err}")

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True)

    lib_err = _max_err(library().transpose(1, 2), exp)
    flops = 4 * (sq * (sq + 1) // 2) * Hq * D
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_F32_FLOPS)
    return {
        "name": "prefill_attention[f32]", "kernel": "prefill_attention",
        "variant": "f32-query", "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda",
        "source": kpre.SOURCE,
        "replaces": kpre.REPLACES, "max_abs_err": err, "tol": F32_TOL,
        **_times([lambda: ops.flash_attention(q, k, v)], [lambda: kpre.plain(q, k, v)],
                 [library]),
        "library": "scaled_dot_product_attention (f32)", "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B=1 Sq=Sk={sq} Hq={Hq} Hkv={Hkv} D={D} q, K/V f32 causal q_offset=0",
    }


def _poison(pool, spool, tables, lengths, bs: int, nan: bool):
    """Copies of a pool and its scales with null block 0 and every
    position past its row's length inside a live block set to NaN (``nan``;
    an fp8 payload of 0x7F, an int8 payload of 127 with a NaN scale) or
    to zeros."""
    pool, spool = pool.clone(), None if spool is None else spool.clone()
    if pool.dtype == torch.float8_e4m3fn:
        fill = 0x7F if nan else 0
    elif pool.dtype == torch.int8:
        fill = 127 if nan else 0
    else:
        fill = float("nan") if nan else 0.0
    sfill = float("nan") if nan else 0.0
    rows = ref.byte_view(pool)
    rows[0] = fill
    if spool is not None:
        spool[0] = sfill
    for b, n in enumerate(lengths.tolist()):
        if 0 < n < tables.shape[1] * bs and n % bs:
            blk = int(tables[b, n // bs])
            rows[blk, :, n % bs:] = fill
            if spool is not None:
                spool[blk, :, n % bs:] = sfill
    return pool, spool


def paged_phase(dev, kv: str | None = None, bs: int = 16) -> dict:
    """llama3.2-1b paged decode attention at the serve shapes: 16 slots,
    block 16, 64 blocks per row, a pool of 1025 blocks, bf16 queries; the
    decode row's ragged lengths (clamped to 1024 by the kernel), a
    scrambled table and garbage in null block 0 (of the scale pools too).
    ``kv``: an fp8/int8 pool with its f32 scale pools.  ``bs``: another
    block size over the same 1024 positions (``--block-size 128``: 8
    blocks per row)."""
    B, Hkv, G, D, MB = 16, 8, 4, 64, 1024 // bs
    N = B * MB + 1
    name = _row_name("paged_decode_attention", ",".join(
        x for x in (kv, None if bs == 16 else f"bs{bs}") if x) or None)
    gen = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(5)) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(LENGTHS):
        k = min(-(-n // bs), MB)
        tables[b, :k] = perm[used:used + k]
        used += k
    tables = tables.to(dev)
    elem = 2 if kv is None else 1
    pool_bytes = 2 * N * Hkv * bs * D * elem
    n_copies = max(1, math.ceil(2 * L2_BYTES / pool_bytes))
    sets = []
    for _ in range(n_copies):
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).bfloat16()
        kf = torch.randn(N, Hkv, bs, D, generator=gen, device=dev)
        vf = torch.randn(N, Hkv, bs, D, generator=gen, device=dev)
        kf[0], vf[0] = 99.0, -99.0
        (kp, ks), (vp, vs) = _quantize(kf, kv), _quantize(vf, kv)
        if kv is not None:
            ks[0], vs[0] = 7.5, -3.0
        sets.append((q, kp, vp, ks, vs))

    def call(fn, q, kp, vp, ks, vs, **kw):
        return fn(q, kp, vp, tables, lengths, k_scale=ks, v_scale=vs, **kw)

    q, kp, vp, ks, vs = sets[0]
    out = call(ops.paged_decode_attention, *sets[0])
    exp = call(kpaged.plain, *sets[0])
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    # float32 mode: f32 queries over the bf16 / quantized pool
    err32 = _max_err(call(ops.paged_decode_attention, q.float(), kp, vp, ks, vs),
                     call(kpaged.plain, q.float(), kp, vp, ks, vs))
    # a hot window and the lse (row 0's window is empty: out 0, lse <= -1e30)
    starts = (lengths // 3).to(torch.int32)
    starts[0] = 5
    out_w, lse = call(ops.paged_decode_attention, *sets[0], starts=starts, return_lse=True)
    exp_w, exp_lse = call(kpaged.plain, *sets[0], starts=starts, return_lse=True)
    torch.cuda.synchronize()
    err_w = max(_max_err(out_w, exp_w), _max_err(lse[1:], exp_lse[1:]))
    # NaN in null block 0 and past each row's length inside its last live
    # block is never read: the kernel on that pool equals the plain version
    # on the pool with zeros there
    (kd, ksd), (vd, vsd) = (_poison(p, sc, tables, lengths, bs, nan=True)
                            for p, sc in ((kp, ks), (vp, vs)))
    (kc, ksc), (vc, vsc) = (_poison(p, sc, tables, lengths, bs, nan=False)
                            for p, sc in ((kp, ks), (vp, vs)))
    out_n = call(ops.paged_decode_attention, q, kd, vd, ksd, vsd)
    err_n = (_max_err(out_n, call(kpaged.plain, q, kc, vc, ksc, vsc))
             if bool(torch.isfinite(out_n).all()) else math.inf)
    # every window empty: the cold launch of a step with nothing spilled
    out_e, lse_e = ops.paged_decode_attention(q, kp, vp, tables, torch.zeros_like(lengths),
                                              return_lse=True, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    empty_ok = float(out_e.abs().max()) == 0.0 and float(lse_e.max()) <= -1e30
    print(f"{name} kernel checks: bf16 err {err:.2e}, f32-query err {err32:.2e}, "
          f"window+lse err {err_w:.2e}, empty window lse {float(lse[0].max()):.3e}, "
          f"NaN-garbage err {err_n:.2e}, all windows empty: out 0 and lse "
          f"{float(lse_e.max()):.3e} {'ok' if empty_ok else 'FAILED'}")
    if not (err <= BF16_TOL and err32 <= F32_TOL and err_w <= BF16_TOL and err_n <= BF16_TOL
            and float(out_w[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30
            and empty_ok):
        raise AssertionError(f"{name} kernel vs plain: {err}, {err32}, {err_w}, {err_n}, "
                             f"all empty {empty_ok}")

    S = MB * bs
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None, None, :]

    def library(q, kp, vp, ks, vs):
        k = ref.gather_paged_cache(kp, tables)
        v = ref.gather_paged_cache(vp, tables)
        if kv is not None:
            k = ref.kv_dequantize(k, ref.gather_paged_scales(ks, tables))
            v = ref.kv_dequantize(v, ref.gather_paged_scales(vs, tables))
        return F.scaled_dot_product_attention(
            q.view(B, Hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_err = _max_err(library(*sets[0]).view(B, Hkv * G, D), exp)
    live = int(lengths.clamp(max=S).sum())
    scale_bytes = 0 if kv is None else 2 * live * Hkv * 4
    nbytes = (2 * live * Hkv * D * elem + scale_bytes + 2 * q.numel() * 2 + B * 4
              + tables.numel() * 4)
    flops = 4 * live * Hkv * G * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS if kv is None
                                else PEAK_8BIT_OPS)
    return {
        "name": name, "kernel": "paged_decode_attention", "variant": kv or "unscaled",
        "heads": kernel_heads(Hkv, G, D, bs), "route": "cuda", "source": kpaged.SOURCE,
        "replaces": kpaged.REPLACES, "max_abs_err": max(err, err_w), "tol": BF16_TOL,
        "f32_query_max_abs_err": err32,
        **_times([lambda s=s: call(ops.paged_decode_attention, *s) for s in sets],
                 [lambda s=s: call(kpaged.plain, *s) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        "library": "ref.gather_paged_cache (k, v) + scaled_dot_product_attention"
                   if kv is None else "ref.gather_paged_cache + gather_paged_scales + "
                   "kv_dequantize (k, v) + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} Hkv={Hkv} G={G} D={D} block={bs} MB={MB} N={N} q bf16, pool "
                 f"{kv or 'bf16'} live={live} "
                 f"split={kpaged.plan(MB, bs, B, Hkv, kdec.sm_count(dev))}",
    }


# ------------------------------------------------------------ serve phase
def load_model():
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    t0 = time.perf_counter()
    model, params = serve.load_model(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"serve: {cfg.name} n_params={model.n_params()} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"weights {time.perf_counter() - t0:.1f}s")
    return model, params


def _expected(per_row: dict[str, int], rows: dict[str, dict]):
    """The launches ``per_row`` names per kernel row, summed per kernel
    and variant, and per kernel, variant and head shape: what the launch
    counters must read (rows of one shape, such as a whole prompt and a
    chunk, share a key)."""
    by_variant = {k: {} for k in ops.KERNELS}
    by_shape = {k: {} for k in ops.KERNELS}
    for name, n in per_row.items():
        r = rows[name]
        v, key = by_variant[r["kernel"]], (r["variant"], r["heads"])
        v[r["variant"]] = v.get(r["variant"], 0) + n
        by_shape[r["kernel"]][key] = by_shape[r["kernel"]].get(key, 0) + n
    return by_variant, by_shape


class PathRun(NamedTuple):
    launches: dict[str, int]          # kernel row -> launches in the async run
    stats: object
    tokens: list[list[int]]           # each request's greedy tokens
    wall_s: float
    res: object                       # the async run's serve.ServeResult


def _rate(res) -> str:
    st = res.stats
    return (f"{st.generated / res.wall_s:.1f} tok/s, "
            f"{res.wall_s * 1e3 / st.engine_steps:.3f} ms per engine step")


def graph_summary(eng) -> str:
    """Each dispatch kind's program: calls, graph replays and capture
    time; raises unless every program of a graphs engine was captured."""
    if eng.graphs and any(p.graph is None for p in eng.programs.values()):
        raise AssertionError(f"uncaptured programs: {eng.programs}")
    return ", ".join(f"{k} {p.calls} calls/{p.replays} replays/capture "
                     f"{p.capture_s * 1e3:.1f} ms" for k, p in eng.programs.items())


def serve_phase(model, params, label: str, flags: list[str], want, rows: dict[str, dict],
                tiered: bool = False, base: PathRun | None = None,
                draft=None, min_accept: float = 0.0, eager: bool = False,
                open_loop: bool = False, preempt_ok: bool = False) -> PathRun:
    """One path through the serve entry point, every dispatch kind one
    CUDA graph: a short warm-up, the async
    run with every launch counter zeroed before it and read after it,
    then the sync run (``eager``: then the async run with ``--graphs
    off``, whose tokens and launches must be the graph run's); checks
    launches per kernel row (``want(stats)``:
    row name -> launches, summed per kernel and variant and per head shape
    against the counters), completion, a drained pool, sync/async greedy
    identity, (``tiered``) spills without preemption and (``base``: the
    non-speculative run of a superset of these requests) token identity
    with it.  ``draft``: the speculative draft (model, params) instead of
    the serve CLI's default; ``min_accept``: the least acceptance rate.
    ``open_loop``: arrivals over rounds, so sync and async step clocks may
    differ (the async engine frees a finished slot when it observes it, a
    step later, so an arrival or a resubmission is admitted later; the
    reference's engines differ alike) and requests are paired by prompt
    (an agentic turn's prompt grows from its session's earlier output and
    resubmission round); tokens must still be identical, on the tiered
    pool by its criterion, whose first tokens are compared where both
    modes began a request's prefills at the same positions (a prefix read
    from the quantized pool is not bit-equal to one recomputed, and the
    modes' hits differ with their timing): such a path runs traced.
    ``preempt_ok``: a tiered path whose host tier fills may preempt."""
    cfg = model.cfg
    t_phase = time.perf_counter()
    # traced for the prefill chunks' positions; the trace is not written
    if open_loop and tiered:
        flags = flags + ["--trace", str(Path(tempfile.gettempdir()) / "unwritten.json"),
                         "--profile", "0"]
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--async", "on"])
    warm = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--requests", "4"])
    serve.serve(warm, model, params, draft)    # warm-up: cuBLAS handles, allocator

    ops.reset_launch_counts()
    res = serve.serve(args, model, params, draft)      # the path's main run
    launches, shapes = ops.variant_counts(), ops.shape_counts()
    print(f"[{label}] serve {' '.join(flags) or '(dense, decode-only)'}")
    for line in serve.report(args, res):
        print(f"[{label}] {line}")
    st = res.stats
    per_row = {name: n for name, n in want(st).items() if n}
    exp_variant, exp_shape = _expected(per_row, rows)
    print(f"[{label}] preemptions={st.preemptions} victim_drains={st.victim_drains} "
          f"spills={st.spills} rehydrations={st.rehydrations} "
          f"dispatches={dict(res.engine.dispatch_counts)} launches: {launches} expected "
          f"{exp_variant}; by head shape {shapes}")
    if not res.engine.graphs:
        raise AssertionError(f"[{label}] the serve path ran without graphs")
    print(f"[{label}] graphs: {graph_summary(res.engine)}; {_rate(res)}")
    if launches != exp_variant or shapes != exp_shape:
        raise AssertionError(f"[{label}] kernel launches {launches} / {shapes} != expected "
                             f"{exp_variant} / {exp_shape}")
    if args.cache == "paged" and res.engine.pool.in_use:
        raise AssertionError(f"[{label}] pool holds {res.engine.pool.in_use} blocks after "
                             "the run")
    if tiered and not (st.spills >= 1 and (st.preemptions == 0 or preempt_ok)):
        raise AssertionError(f"[{label}] spills={st.spills} preemptions={st.preemptions}: "
                             "the tiered pool should spill, not preempt")
    reqs = res.driver.submitted
    for r in reqs:
        if not (r.done and len(r.out_tokens) == args.max_new
                and all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"[{label}] request {r.uid}: done={r.done} "
                                 f"tokens={len(r.out_tokens)}")
    if args.spec_depth:
        short = sum(x < 1.0 for x in st.spec_accept_samples)
        print(f"[{label}] acceptance rate {st.acceptance_rate:.4f}: "
              f"{len(st.spec_accept_samples)} windows, {short} below 1.0; "
              f"spec_steps={st.spec_steps} decode_steps={st.decode_steps} "
              f"draft_steps={st.draft_steps}")
        if st.spec_steps != st.decode_steps or st.acceptance_rate < min_accept:
            raise AssertionError(f"[{label}] a decode dispatch ran without speculation, "
                                 f"or acceptance under {min_accept}")
    if base is not None:
        differ = [(r.uid, next(i for i, (x, y) in enumerate(zip(r.out_tokens, b)) if x != y))
                  for r, b in zip(reqs, base.tokens) if r.out_tokens != b]
        print(f"[{label}] vs the non-speculative run: {len(reqs) - len(differ)}/{len(reqs)} "
              f"requests token-identical; differing (uid, first position): {differ}")
        if differ:
            raise AssertionError(f"[{label}] speculative greedy tokens differ from the "
                                 "non-speculative run's")

    if eager:
        eager_args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--graphs", "off"])
        ops.reset_launch_counts()
        ref_run = serve.serve(eager_args, model, params, draft)
        same_eager = [r.out_tokens for r in ref_run.driver.submitted] == [
            r.out_tokens for r in reqs]
        print(f"[{label}] graphs vs eager (async, same call): graphs {_rate(res)}; eager "
              f"{_rate(ref_run)}; greedy tokens identical: {same_eager}; launches equal: "
              f"{ops.shape_counts() == shapes}")
        if not (same_eager and ops.shape_counts() == shapes
                and ref_run.stats.engine_steps == st.engine_steps):
            raise AssertionError(f"[{label}] graph and eager runs differ")

    sync_args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--async", "off"])
    sync = serve.serve(sync_args, model, params, draft)
    for line in serve.report(sync_args, sync):
        print(f"[{label}] {line}")
    print(f"[{label}] sync graphs: {graph_summary(sync.engine)}")
    pairs = list(zip(reqs, sync.driver.submitted))
    if open_loop:
        by_prompt = {r.prompt.tobytes(): r for r in reqs}
        pairs = [(by_prompt[b.prompt.tobytes()], b) for b in sync.driver.submitted
                 if b.prompt.tobytes() in by_prompt]
        if len(pairs) < args.requests:
            raise AssertionError(f"[{label}] only {len(pairs)} sync requests have an async "
                                 "request of the same prompt")
    same = [a.out_tokens == b.out_tokens for a, b in pairs]
    same_clock = sync.stats.engine_steps == st.engine_steps
    print(f"[{label}] sync vs async greedy: {sum(same)}/{len(same)} requests "
          f"token-identical (of {len(reqs)} async, {len(sync.driver.submitted)} sync); "
          f"engine steps async {st.engine_steps}, sync {sync.stats.engine_steps}; rounds "
          f"async {res.rounds}, sync {sync.rounds}")
    if (same_clock or args.spec_depth or (open_loop and not tiered)) and not all(same):
        raise AssertionError(f"[{label}] sync and async greedy tokens differ")
    if not same_clock and open_loop and not tiered:
        print(f"[{label}] step clocks differ (open-loop arrivals admitted a step later "
              "in async mode)")
    elif not same_clock and args.spec_depth:
        # the async engine plans from the one token a window surely
        # commits, so it dispatches windows past a finish that accepted
        # drafts brought forward (masked when observed): more steps, the
        # same tokens, as in the reference
        print(f"[{label}] step clocks differ (async dispatches past early finishes)")
    elif not same_clock:
        # Only with a host tier under pool pressure: the reference's async
        # engine spills before it observes the slots that finish this step
        # (sync frees their blocks first), so its chunks and hot/cold
        # splits land elsewhere and bf16 rounding may flip near-ties.  Hold
        # the runs to the reference's own quantized-pool criterion
        # (tests/test_kv_tiering.py): every first token equal, >= 60% of all.
        tokens = [(x, y) for a, b in pairs for x, y in zip(a.out_tokens, b.out_tokens)]
        agree = sum(x == y for x, y in tokens) / len(tokens)
        print(f"[{label}] step clocks differ (async spills before observing); "
              f"{agree:.1%} of tokens equal")
        first = pairs
        if res.tracer is not None:
            starts = ({}, {})
            for by_uid, run in zip(starts, (res, sync)):
                for sp in run.tracer.spans:
                    if sp.name == "prefill_chunk":
                        by_uid.setdefault(sp.uid, []).append(sp.attrs["pos"])
            first = [(a, b) for a, b in pairs if starts[0][a.uid] == starts[1][b.uid]]
            other = [a.out_tokens[0] == b.out_tokens[0] for a, b in pairs
                     if starts[0][a.uid] != starts[1][b.uid]]
            print(f"[{label}] {len(first)}/{len(pairs)} requests began their prefills at the "
                  f"same positions in both modes; the others' first tokens equal: "
                  f"{sum(other)}/{len(other)}")
        if not (tiered and agree >= 0.6
                and all(a.out_tokens[0] == b.out_tokens[0] for a, b in first)):
            raise AssertionError(f"[{label}] sync and async runs diverge")
    wall = time.perf_counter() - t_phase
    print(f"[{label}] phase wall {wall:.1f}s (warm-up, async and sync runs)")
    return PathRun(per_row, st, [r.out_tokens for r in reqs], wall, res)


def observatory_phase(model, params) -> None:
    """The paged-hybrid path traced (``--trace`` to a file in the temporary
    directory) and profiled (``--profile 8``: every eighth dispatch fenced
    on the card with ``torch.cuda.synchronize``) against the same run
    untraced, in this call.  The trace must validate and hold one finished,
    well-formed request tree per submitted request; tokens, ``EngineStats``
    and launch counts must equal the untraced run's; no sampled dispatch may
    be one that captured its kind's graph; no sample's measured MFU or MBU
    (against the H100 SXM's peaks) may exceed ``MAX_SHARE``.  Prints, per
    dispatch kind, the samples, median measured ms, MFU, MBU and GB/s, and
    tok/s traced vs untraced."""
    t_phase = time.perf_counter()
    trace = Path(tempfile.gettempdir()) / f"chip_smoke_trace_{os.getpid()}.json"
    runs = {}
    for label, extra in (("untraced", []),
                         ("traced", ["--trace", str(trace), "--profile", str(PROFILE_EVERY)])):
        args = serve.build_parser().parse_args(SERVE_FLAGS + PAGED_FLAGS + extra)
        ops.reset_launch_counts()
        res = serve.serve(args, model, params)
        runs[label] = (res, ops.shape_counts())
        for line in serve.report(args, res) + serve.write_outputs(args, res):
            print(f"[observatory {label}] {line}")
    (plain, plain_counts), (res, counts) = runs["untraced"], runs["traced"]
    obj = json.loads(trace.read_text())
    trace.unlink()
    problems = validate_trace(obj)
    if problems:
        raise AssertionError(f"[observatory] invalid trace: {problems[:5]}")
    trees = build_request_trees(res.tracer)
    uids = {r.uid for r in res.driver.submitted}
    bad = [t.well_formed() for t in trees.values() if not t.finished or t.well_formed()]
    print(f"[observatory] trace: {len(obj['traceEvents'])} events, {len(trees)} request trees "
          f"for {len(uids)} requests, {len(res.tracer.steps)} step records; malformed {bad}")
    if {uid for _, uid in trees} != uids or bad:
        raise AssertionError("[observatory] the trace does not cover every request")
    same = ([r.out_tokens for r in res.driver.submitted]
            == [r.out_tokens for r in plain.driver.submitted])
    print(f"[observatory] traced vs untraced: tokens identical {same}, stats equal "
          f"{res.stats == plain.stats}, launches equal {counts == plain_counts}; "
          f"untraced {_rate(plain)}; traced {_rate(res)}")
    if not (same and res.stats == plain.stats and counts == plain_counts):
        raise AssertionError("[observatory] tracing changed the run")
    eng, samples = res.engine, res.profiler.samples
    captured = set(eng.capture_steps.items())
    ticks = sum(eng.dispatch_counts.values()) - len(captured)
    print(f"[observatory] {len(samples)} sampled dispatches of {ticks} counted; captures "
          f"(kind, step) {sorted(captured)}")
    if {(s.kind, s.step) for s in samples} & captured or len(samples) != ticks // PROFILE_EVERY:
        raise AssertionError("[observatory] a capturing dispatch was sampled, or the "
                             "sampling missed dispatches")
    for kind in sorted({s.kind for s in samples}):
        ss = [s for s in samples if s.kind == kind]
        med = {k: statistics.median(getattr(s, k) for s in ss)
               for k in ("seconds", "measured_mfu", "measured_mbu", "achieved_gbps")}
        top = max(max(s.measured_mfu, s.measured_mbu) for s in ss)
        print(f"[observatory] measured {kind}: {len(ss)} samples, median "
              f"{med['seconds'] * 1e3:.3f} ms, mfu {med['measured_mfu']:.4f}, mbu "
              f"{med['measured_mbu']:.4f}, {med['achieved_gbps']:.1f} GB/s; largest share "
              f"{top:.4f} (device {res.profiler.device.name})")
        if top > MAX_SHARE:
            raise AssertionError(f"[observatory] {kind}: a measured share {top:.4f} > "
                                 f"{MAX_SHARE}")
    print(f"[observatory] phase wall {time.perf_counter() - t_phase:.1f}s")


def agreement(label: str, reqs, base: PathRun, exact: bool = False,
              floor: bool = True) -> None:
    """Token agreement of a full-width path with the single-engine path
    ``base`` of the same workload (requests paired by uid): prints the
    requests and the share of tokens identical; raises under the tiered
    criterion (every first token equal, at least ``TOKEN_FLOOR`` of all
    tokens), or (``exact``) unless every token is identical; ``floor=False``
    only prints.  At bf16 a replica batches other rows than the single engine
    does (and a sub-batch half of them), so its GEMMs may round otherwise
    and a near-tie may flip; a flip changes that request's later tokens."""
    pairs = list(zip([r.out_tokens for r in reqs], base.tokens, strict=True))
    same = sum(a == b for a, b in pairs)
    tokens = [(x, y) for a, b in pairs for x, y in zip(a, b, strict=True)]
    share = sum(x == y for x, y in tokens) / len(tokens)
    first = sum(a[0] == b[0] for a, b in pairs)
    print(f"[{label}] vs the {len(base.res.engine.slots)}-slot "
          f"single-engine path: {same}/{len(pairs)} requests token-identical, {share:.1%} "
          f"of tokens, first tokens equal {first}/{len(pairs)}")
    if exact and same != len(pairs):
        raise AssertionError(f"[{label}] tokens differ from the single-engine path's")
    if floor and (first != len(pairs) or share < TOKEN_FLOOR):
        raise AssertionError(f"[{label}] under the token floor against the single-engine path")


class _Summed:
    """The step-clock fields of a cluster's replicas, summed (what the
    launch counters read over the whole cluster)."""

    def __init__(self, engines):
        for f in ("prefills", "prefill_chunks", "decode_steps", "engine_steps",
                  "migrations_out", "migrations_in"):
            setattr(self, f, sum(getattr(e.stats, f) for e in engines))


def cluster_phase(model, params, label: str, flags: list[str], want, rows: dict[str, dict],
                  base: PathRun, tiered: bool = False) -> PathRun:
    """A two-replica cluster through the serve entry point, every replica's
    dispatch kinds CUDA graphs: a short warm-up, then the async run with
    every launch counter zeroed before it and read after it.  Checks the
    launches per kernel row over both replicas (``want`` of the summed
    step clocks), completion, drained pools, (``tiered``) spills on every
    replica; with a
    role map, that no migration is lost (every export was imported, every
    request finished: one that found no decode replica decoded at home);
    and the token floor against ``base``.  Prints the cluster's lines,
    tokens per round, round-clock TTFT, hit rate, tok/s, per-replica
    graphs and step clocks."""
    t_phase = time.perf_counter()
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags)
    warm = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--requests", "4"])
    serve.serve(warm, model, params)
    ops.reset_launch_counts()
    res = serve.serve(args, model, params)
    launches, shapes = ops.variant_counts(), ops.shape_counts()
    cl, cs = res.cluster, res.stats
    tot = _Summed(cl.engines)
    print(f"[{label}] serve {' '.join(flags)}")
    for line in serve.report(args, res):
        print(f"[{label}] {line}")
    per_row = {name: n for name, n in want(tot).items() if n}
    exp_variant, exp_shape = _expected(per_row, rows)
    print(f"[{label}] launches: {launches} expected {exp_variant}")
    if launches != exp_variant or shapes != exp_shape:
        raise AssertionError(f"[{label}] kernel launches {launches} / {shapes} != expected "
                             f"{exp_variant} / {exp_shape}")
    for i, eng in enumerate(cl.engines):
        st = eng.stats
        print(f"[{label}] r{i}[{eng.role}] {serve.stats_line(cs.replicas[i].routed, st)}; "
              f"spills={st.spills} rehydrations={st.rehydrations} "
              f"preemptions={st.preemptions} migrations out/in={st.migrations_out}/"
              f"{st.migrations_in}; graphs: {graph_summary(eng)}")
        if not eng.graphs:
            raise AssertionError(f"[{label}] replica {i} ran without graphs")
        if args.cache == "paged" and eng.pool.in_use:
            raise AssertionError(f"[{label}] replica {i}'s pool holds {eng.pool.in_use} blocks")
    reqs = res.driver.submitted
    bad = [r.uid for r in reqs if not (r.done and len(r.out_tokens) == args.max_new)]
    if bad:
        raise AssertionError(f"[{label}] requests {bad} did not finish")
    if tiered and not all(e.stats.spills for e in cl.engines):
        raise AssertionError(f"[{label}] a replica's tiered pool never spilled")
    if cl.disaggregated:
        home = sum(1 for r in reqs if cl.placement[r.uid] == 0)
        print(f"[{label}] migrations {cs.migrations} (exported {tot.migrations_out}, imported "
              f"{tot.migrations_in}); {home} requests finished on the prefill replica "
              f"(no decode replica could take them when they were tried)")
        if not (cs.migrations > 0 and tot.migrations_out == tot.migrations_in == cs.migrations
                and cs.migrations + home == len(reqs)):
            raise AssertionError(f"[{label}] a migration was lost")
    print(f"[{label}] rounds {cs.rounds}, {cs.tokens_per_round:.3f} tokens per round, "
          f"ttft_rounds mean {cs.mean_ttft_rounds:.2f} p99 {cs.ttft_rounds_percentile(99):.0f}, "
          f"prefix hit rate {cs.prefix_hit_rate:.4f}, imbalance {cs.load_imbalance:.3f}; "
          f"{cs.generated / res.wall_s:.1f} tok/s, {res.wall_s * 1e3 / cs.rounds:.3f} ms per "
          f"round, {res.wall_s * 1e3 / tot.engine_steps:.3f} ms per engine step")
    agreement(label, reqs, base)
    wall = time.perf_counter() - t_phase
    print(f"[{label}] phase wall {wall:.1f}s (warm-up and async run)")
    return PathRun(per_row, cs, [r.out_tokens for r in reqs], wall, res)


def _concurrency(kernels: list[dict]) -> tuple[float, float, float]:
    """Over kernel events (``ts``, ``dur`` in us, ``args.stream``): the time
    some kernel runs, the time two or more run at once, and the time kernels
    of two or more stream ids run at once."""
    marks = sorted([(e["ts"], 1, e["args"].get("stream", -1)) for e in kernels]
                   + [(e["ts"] + e["dur"], -1, e["args"].get("stream", -1)) for e in kernels])
    live: dict[int, int] = {}
    busy = many = streams = 0.0
    last = None
    for t, d, sid in marks:
        if last is not None:
            n = sum(live.values())
            busy += (t - last) if n else 0.0
            many += (t - last) if n > 1 else 0.0
            streams += (t - last) if sum(v > 0 for v in live.values()) > 1 else 0.0
        live[sid] = live.get(sid, 0) + d
        last = t
    return busy, many, streams


def sub_batch_phase(model, params) -> None:
    """``--sub-batches 2`` against ``--sub-batches 1`` on the dense path: the
    serve run of each in turns (1, 2, 2, 1; async, graphs), wall ms per
    engine step; then ``torch.profiler`` over 8 steady decode steps of a
    ``sub_batches=2`` engine with graphs and eagerly: kernels per stream id,
    and how long kernels of two streams ran at once (all kernels, and the
    dense decode kernel's), from the trace's timestamps."""
    t_phase = time.perf_counter()
    ms = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        args = serve.build_parser().parse_args(SERVE_FLAGS + ["--sub-batches", str(n)])
        res = serve.serve(args, model, params)
        ms[n].append(res.wall_s * 1e3 / res.stats.engine_steps)
    print("[sub-batches] wall ms per engine step, in turns 1, 2, 2, 1 (dense, async, graphs): "
          f"--sub-batches 1 {ms[1][0]:.3f}, {ms[1][1]:.3f}; --sub-batches 2 {ms[2][0]:.3f}, "
          f"{ms[2][1]:.3f}; ratio of means {statistics.mean(ms[2]) / statistics.mean(ms[1]):.3f}")
    for graphs in (True, False):
        args = serve.build_parser().parse_args(SERVE_FLAGS + SUB_BATCH_FLAGS
                                               + ["--graphs", "on" if graphs else "off"])
        eng = serve.make_engine(args, model, params)
        for i, arr in enumerate(build_workload("random", args.slots, vocab=model.cfg.vocab,
                                               max_seq=args.max_seq, max_new=args.max_new,
                                               seed=1)):
            eng.submit(Request(uid=i, prompt=arr.prompt, max_new_tokens=arr.max_new_tokens))
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 8
        eng.run()
        path = Path(tempfile.gettempdir()) / f"chip_smoke_sub_{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        path.unlink()
        kernels = [e for e in trace["traceEvents"]
                   if e.get("cat") == "kernel" and e.get("ph") == "X"]
        mode = "graphs" if graphs else "eager"
        if not kernels:
            print(f"[sub-batches {mode}] profile: wall {wall_ms:.3f} ms/step; kernel overlap "
                  "not measured (the profiler saw no kernels)")
            continue
        per_stream: dict[int, int] = {}
        for e in kernels:
            sid = e["args"].get("stream", -1)
            per_stream[sid] = per_stream.get(sid, 0) + 1
        busy, many, streams = _concurrency(kernels)
        _, attn_many, _ = _concurrency([e for e in kernels if "decode_split" in e["name"]])
        print(f"[sub-batches {mode}] profile over 8 decode steps: wall {wall_ms:.3f} ms/step, "
              f"kernels busy {busy / 8e3:.3f} ms/step; kernels per stream id {per_stream}; "
              f"two or more kernels at once {many / 8e3:.3f} ms/step "
              f"({many / max(busy, 1e-9):.1%} of the busy time; of two stream ids "
              f"{streams / 8e3:.3f}); two decode-kernel launches at once "
              f"{attn_many / 8e3:.4f} ms/step")
    print(f"[sub-batches] overlap phase wall {time.perf_counter() - t_phase:.1f}s")


# host-side launch calls the profiler records, by what they launch
GRAPH_LAUNCH = ("cudaGraphLaunch",)
KERNEL_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profile_phase(model, params, label: str, flags: list[str], warm_steps: int,
                  n_steps: int = 8, graphs: bool = True) -> None:
    """Where a steady step's time goes: ``torch.profiler`` over ``n_steps``
    async steps after ``warm_steps`` (32 requests over 16 slots), with
    every dispatch kind one CUDA graph or (``graphs=False``) eagerly.
    Prints wall time per step, device busy time per step (the device-side
    events' time: kernels, copies and fills), device ops and host launch
    calls per step (graph launches and kernel launches apart) and the top
    kernels; reports "not measured" if the profiler sees no device time.  With a host tier, also times one layer's hot and cold
    paged launches on the state the window ended in."""
    label = f"{label}{'' if graphs else ' eager'}"
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags
                                           + ["--graphs", "on" if graphs else "off"])
    eng = serve.make_engine(args, model, params)
    for i, arr in enumerate(build_workload("random", 2 * args.slots, vocab=model.cfg.vocab,
                                           max_seq=args.max_seq, max_new=args.max_new,
                                           seed=1)):
        eng.submit(Request(uid=i, prompt=arr.prompt, max_new_tokens=arr.max_new_tokens))
    for _ in range(warm_steps):
        eng.step()
    torch.cuda.synchronize()
    st0 = dataclasses.replace(eng.stats)
    replays0 = sum(p.replays for p in eng.programs.values())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    st = eng.stats
    replays = sum(p.replays for p in eng.programs.values()) - replays0
    mix = (f"{st.decode_steps - st0.decode_steps} decode batches (mean "
           f"{(st.generated - st0.generated) / n_steps:.1f} tokens/step), "
           f"{st.prefill_chunks - st0.prefill_chunks} prefill chunks in {n_steps} steps, "
           f"{replays / n_steps:.2f} graph replays/step")
    events = prof.key_averages()
    launch_calls = {kind: sum(e.count for e in events if e.key in names) / n_steps
                    for kind, names in (("graph", GRAPH_LAUNCH), ("kernel", KERNEL_LAUNCH))}
    if "host_k" in eng.cache:
        tier_launches(eng, label)
    eng.run()
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched, which are events of their own
    rows = [e for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    if not rows:
        print(f"[{label}] profile: wall {wall_ms:.2f} ms/step; device time not "
              f"measured (the profiler saw no device activity); host launches/step: "
              f"{launch_calls['graph']:.2f} graph, {launch_calls['kernel']:.1f} kernel; {mix}")
        return
    print(f"[{label}] profile: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} "
          f"ms/step ({busy_ms / wall_ms:.0%}), {sum(e.count for e in rows) // n_steps} "
          f"device ops/step, host launches/step: {launch_calls['graph']:.2f} graph, "
          f"{launch_calls['kernel']:.1f} kernel; {mix}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
              f"{e.count / n_steps:7.1f}x  {e.key[:90]}")
    for e in rows:                   # every launch of the port's kernels, by kernel
        name = next((n for n in PORT_KERNELS if n in e.key), None)
        if name:
            print(f"[{label}] port kernel {name}: {e.self_device_time_total / 1e3 / n_steps:.4f}"
                  f" ms/step over {e.count / n_steps:.1f} launches/step "
                  f"({e.self_device_time_total / max(e.count, 1):.2f} us each)")


def tier_launches(eng, label: str) -> None:
    """The two paged calls of one layer of a tiered decode step, on the
    engine's current cache (layer 0, random bf16 queries): the hot window
    ``[cold_len, len)`` of the device pool and the cold prefix in the host
    pool.  Device time per call (:func:`_device_ms`: split and combine
    kernels), and the host's time per call (wrapper included) over 30
    back-to-back calls."""
    c, cfg = eng.cache, eng.model.cfg
    gen = torch.Generator(device=eng.device).manual_seed(7)
    q = torch.randn(len(eng.slots), cfg.n_heads, cfg.resolved_head_dim(), generator=gen,
                    device=eng.device).bfloat16()
    scales = "k_scale" in c

    def hot():
        return ops.paged_decode_attention(
            q, c["k"][0], c["v"][0], c["block_tables"], c["lengths"],
            starts=c["cold_lengths"], return_lse=True,
            k_scale=c["k_scale"][0] if scales else None,
            v_scale=c["v_scale"][0] if scales else None)

    def cold():
        return ops.paged_decode_attention(
            q, c["host_k"][0], c["host_v"][0], c["host_tables"], c["cold_lengths"],
            return_lse=True, k_scale=c["host_k_scale"][0] if scales else None,
            v_scale=c["host_v_scale"][0] if scales else None)

    def host_ms(fn, n=30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    cap = c["block_tables"].shape[1] * eng.block_size
    live = c["lengths"].clamp(max=cap)
    cold_n = int(c["cold_lengths"].sum())
    hot_n = int((live - c["cold_lengths"]).clamp(min=0).sum())
    dev = {k: _device_ms([fn]) for k, fn in (("hot", hot), ("cold", cold))}
    print(f"[{label}] tier launches (layer 0, this state): hot device {dev['hot']:.4f} ms "
          f"over {hot_n} positions, cold device {dev['cold']:.4f} ms over {cold_n} positions in "
          f"{int((c['cold_lengths'] > 0).sum())} slots; host per call {host_ms(hot):.4f} / "
          f"{host_ms(cold):.4f} ms; spills so far {eng.stats.spills}")


def _reduced_pair(dev, seeds=(3,)):
    """Reduced llama3.2-1b in float32 on the GPU and on the CPU, with the
    same weights for each seed: (gpu, cpu, [(gpu params, cpu params)])."""
    cfg = reduce_config("llama3.2-1b").with_overrides(dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    out = []
    for seed in seeds:
        p_gpu = gpu.init(seed=seed)
        out.append((p_gpu, {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                                else v.cpu()) for k, v in p_gpu.items()}))
    return gpu, cpu, out


def reference_check(dev) -> None:
    """Reduced llama3.2-1b in float32: kernels on the GPU vs the plain path
    on the CPU, same weights.  Dense cache: prefill + 4 decode steps.
    Paged pool (bf16, fp8 and int8, the quantized ones also with a host
    tier holding spilled blocks): :func:`_paged_reference`.  Tolerance
    5e-2 on logits: the plain decode path rounds p to the bf16 cache dtype
    before P·V (as the JAX reference does), the kernels keep it in f32."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(1, gpu.cfg.vocab, (2, 29), generator=gen)
    caches = gpu.init_cache(2, 64), cpu.init_cache(2, 64)
    lg, _ = gpu.prefill(p_gpu, prompt.to(dev), caches[0])
    lc, _ = cpu.prefill(p_cpu, prompt, caches[1])
    worst = _max_err(lg.cpu(), lc)
    for _ in range(4):
        tok = lc.argmax(-1).to(torch.int32)
        lg, _ = gpu.decode_step(p_gpu, caches[0], tok.to(dev))
        lc, _ = cpu.decode_step(p_cpu, caches[1], tok)
        worst = max(worst, _max_err(lg.cpu(), lc))
    print(f"reference check, dense (reduced f32, GPU kernels vs CPU plain): "
          f"max |logit diff| {worst:.3e}")

    worst_paged = {f"{kv}{'+host' if host else ''}":
                   _paged_reference(dev, gpu, cpu, p_gpu, p_cpu, prompt, kv, host)
                   for kv, host in (("bf16", 0), ("fp8", 0), ("fp8", 4), ("int8", 0),
                                    ("int8", 4))}
    print("reference check, paged + chunked prefill (reduced f32, GPU kernels vs CPU "
          "plain): max |logit diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_paged.items()))
    if not (worst <= 5e-2 and max(worst_paged.values()) <= 5e-2):
        raise AssertionError(f"GPU vs CPU logits differ by {worst}, {worst_paged}")


def _paged_reference(dev, gpu, cpu, p_gpu, p_cpu, prompt, kv: str, host: int) -> float:
    """Two prompts in chunks of 16 through ``prefill_step`` into the two
    staging lanes, their blocks written (quantized when ``kv`` is fp8 or
    int8) into scrambled pool blocks, garbage in null block 0 of every
    pool; with ``host`` blocks, lane 0's first two blocks and lane 1's
    first spill to the host tier (cold lengths 16 and 8).  Then 4
    ``paged_decode_step``s.  Max |logit diff|, GPU kernels vs CPU plain."""
    bs, MB, N = 8, 8, 17
    tables = torch.zeros(2, MB, dtype=torch.int32)
    tables[0, :4] = torch.tensor([9, 2, 14, 5])       # 29 prompt + 4 decode positions
    tables[1, :3] = torch.tensor([16, 1, 11])          # 17 + 4
    lens, spilled = (29, 17), (2, 1)
    runs = []
    for model, params, d in ((gpu, p_gpu, dev), (cpu, p_cpu, torch.device("cpu"))):
        staging = model.init_cache(2, MB * bs)
        pool = model.init_paged_cache(2, N, bs, MB, kv_dtype=kv, host_blocks=host)
        for key in ("k", "v", "host_k", "host_v"):                # null-block garbage
            if key in pool:
                ref.byte_view(pool[key])[:, 0] = 50 if key.endswith("k") else 60
                if f"{key}_scale" in pool:
                    pool[f"{key}_scale"][:, 0] = 5.0
        logits = []
        for lane, n in enumerate(lens):
            for start in range(0, n, 16):
                nv = min(16, n - start)
                chunk = torch.zeros(1, 16, dtype=torch.int32)
                chunk[0, :nv] = prompt[lane, start:start + nv]
                lg, _ = model.prefill_step(params, staging, chunk.to(d), lane, start, nv)
            logits.append(lg)
            row = tables[lane].clone()
            for j in range(-(-n // bs)):
                pdev.write_prompt_block(pool, staging, int(row[j]), j * bs, lane)
            if host:
                host_row = torch.zeros(MB, dtype=torch.int32)
                for j in range(spilled[lane]):
                    host_row[j] = 1 + lane * 2 + j
                    pdev.spill_block(pool, int(row[j]), int(host_row[j]))
                    row[j] = 0
                pdev.sync_host_slot(pool, lane, host_row.numpy(), spilled[lane] * bs)
            pdev.sync_slot(pool, lane, row.numpy(), n)
        runs.append((model, params, pool, torch.cat(logits)))
    (gm, gp, gpool, glog), (cm_, cp, cpool, clog) = runs
    worst = _max_err(glog.cpu(), clog)
    for _ in range(4):
        tok = clog.argmax(-1).to(torch.int32)
        glog, _ = gm.paged_decode_step(gp, gpool, tok.to(dev))
        clog, _ = cm_.paged_decode_step(cp, cpool, tok)
        worst = max(worst, _max_err(glog.cpu(), clog))
    return worst


def preemption_check(dev) -> None:
    """Reduced llama3.2-1b on a pool too small for both sequences (8
    usable blocks of 4 tokens): the youngest is preempted and refolded.
    On the GPU, async (victim-only drain) and sync give the same greedy
    tokens, and the step clock equals the CPU engine's (it does not
    depend on token values)."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    prompts = [torch.arange(1, 10, dtype=torch.int32).numpy(),
               torch.arange(3, 8, dtype=torch.int32).numpy()]
    for schedule in ("decode-only", "hybrid"):
        runs = []
        for model, params, async_mode in ((gpu, p_gpu, True), (gpu, p_gpu, False),
                                          (cpu, p_cpu, False)):
            eng = Engine(model, params, n_slots=2, max_seq=32, cache_kind="paged",
                         block_size=4, n_blocks=9, schedule=schedule, prefill_chunk=8,
                         async_mode=async_mode)
            reqs = [Request(uid=i, prompt=p, max_new_tokens=10)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            runs.append((eng.run(), [r.out_tokens for r in reqs], eng.pool.in_use))
        (a, a_tok, a_use), (s_, s_tok, s_use), (c, _, _) = runs
        print(f"preemption check ({schedule}, GPU): preemptions={a.preemptions} "
              f"victim_drains={a.victim_drains} sync/async tokens equal: {a_tok == s_tok}")
        if not (a.preemptions >= 1 and a.victim_drains >= 1 and a_tok == s_tok
                and a_use == s_use == 0
                and (a.engine_steps, a.preemptions, a.decode_steps, a.prefill_chunks)
                == (s_.engine_steps, s_.preemptions, s_.decode_steps, s_.prefill_chunks)
                == (c.engine_steps, c.preemptions, c.decode_steps, c.prefill_chunks)):
            raise AssertionError(f"preemption check ({schedule}) failed: {a} / {s_} / {c}")


def host_tier_check(dev) -> None:
    """Reduced llama3.2-1b in float32 with a host tier (block 4, 8 usable
    device blocks, 8 host blocks), on the GPU, async and sync — the cases
    of ``tests/test_kv_tiering.py``:
    * two sequences that do not fit: live spills, no preemption, and the
      greedy tokens of an unspilled run (the hot/cold lse merge is exact);
    * a finished prompt's prefix spills at free time and re-hydrates for
      the same prompt, which continues identically;
    * a third prompt in the slot the first spilled from decodes as in an
      unspilled run (its cold window starts empty);
    and the step clock of each equals the CPU engine's."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    a, b, c = (torch.arange(lo, hi, dtype=torch.int32).numpy()
               for lo, hi in ((1, 10), (3, 8), (40, 49)))

    def run(model, params, prompts, n_slots=2, **kw):
        eng = Engine(model, params, n_slots=n_slots, max_seq=32, cache_kind="paged",
                     block_size=4, **kw)
        reqs = []
        for i, p in enumerate(prompts):          # one run() per prompt when n_slots == 1
            reqs.append(Request(uid=i, prompt=p, max_new_tokens=10))
            eng.submit(reqs[-1])
            if n_slots == 1:
                eng.run()
        st = eng.run()
        return st, [r.out_tokens for r in reqs], eng.pool.in_use

    for case, prompts, kw in (
            ("spill", [a, b], dict(n_blocks=9, host_blocks=8)),
            ("reuse", [a, b, c], dict(n_blocks=9, host_blocks=8)),
            ("rehydrate", [a, a], dict(n_slots=1, host_blocks=8))):
        _, base, _ = run(gpu, p_gpu, prompts, n_slots=kw.get("n_slots", 2))
        (st, toks, use), (st_s, toks_s, use_s), (st_c, _, _) = (
            run(m, p, prompts, async_mode=am, **kw)
            for m, p, am in ((gpu, p_gpu, True), (gpu, p_gpu, False), (cpu, p_cpu, False)))
        clock = [(x.engine_steps, x.decode_steps, x.spills, x.rehydrations, x.preemptions)
                 for x in (st, st_s, st_c)]
        print(f"host-tier check ({case}, GPU): spills={st.spills} "
              f"rehydrations={st.rehydrations} preemptions={st.preemptions}; tokens == "
              f"unspilled: {toks == base}, sync == async: {toks == toks_s}; step clock "
              f"async/sync/CPU {clock}")
        moved = st.rehydrations >= 2 if case == "rehydrate" else st.spills >= 1
        if not (moved and st.preemptions == 0 and toks == toks_s == base
                and use == use_s == 0 and clock[0] == clock[1] == clock[2]):
            raise AssertionError(f"host-tier check ({case}) failed: {clock}")


SPEC_COMBOS = {
    "dense/decode-only": {},
    "dense/hybrid": dict(schedule="hybrid", prefill_chunk=8),
    "paged/decode-only": dict(cache_kind="paged", block_size=8),
    "paged/hybrid": dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8),
}


def spec_reference_check(dev) -> None:
    """Speculative decoding, reduced llama3.2-1b in float32 (depth 2): the
    engine on the GPU (async and sync) against the CPU engine, same
    weights, over {dense, paged} x {decode-only, hybrid} with a mismatched
    draft and with the target as its own draft: greedy tokens and the
    step clock (engine, spec and draft steps, drafted and accepted tokens,
    prefills, chunks) equal mode for mode (async dispatches windows past a
    finish that accepted drafts brought forward, so its clock may run
    ahead of sync's, in the reference too), and the tokens those of the
    GPU's plain run.  Then :func:`verify_reference_check`."""
    gpu, cpu, ((pt_g, pt_c), (pd_g, pd_c)) = _reduced_pair(dev, seeds=(3, 5))
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10, dtype=np.int32),
               np.arange(2, 13, dtype=np.int32), np.arange(4, 25, dtype=np.int32)]

    def run(model, params, **kw):
        eng = Engine(model, params, n_slots=2, max_seq=32, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        st = eng.run()
        clock = (st.engine_steps, st.spec_steps, st.draft_steps, st.drafted_tokens,
                 st.accepted_tokens, st.prefills, st.prefill_chunks, st.decode_steps)
        return [r.out_tokens for r in reqs], clock, st

    for combo, kw in SPEC_COMBOS.items():
        plain, _, _ = run(gpu, pt_g, **kw)
        for draft, (dg, dc) in (("mismatched", (pd_g, pd_c)), ("target", (pt_g, pt_c))):
            spec = dict(spec_depth=2, **kw)
            (ta, ca, sa), (ts, cs, _), (tca, cca, _), (tcs, ccs, _) = (
                run(m, p, async_mode=am, draft_model=m, draft_params=d, **spec)
                for m, p, d, am in ((gpu, pt_g, dg, True), (gpu, pt_g, dg, False),
                                    (cpu, pt_c, dc, True), (cpu, pt_c, dc, False)))
            ok = (ta == ts == tca == tcs == plain and ca == cca and cs == ccs
                  and sa.spec_steps >= 1)
            print(f"spec reference check ({combo}, {draft} draft): acceptance "
                  f"{sa.acceptance_rate:.3f}; tokens GPU async == sync == CPU == plain: "
                  f"{ta == ts == tca == tcs == plain}; step clock GPU/CPU async {ca} {cca}, "
                  f"sync {cs} {ccs}")
            if not ok:
                raise AssertionError(f"spec reference check ({combo}, {draft}) failed")
    verify_reference_check(dev, gpu, cpu, pt_g, pt_c)


def verify_reference_check(dev, gpu, cpu, p_gpu, p_cpu) -> None:
    """``verify_step`` and ``paged_verify_step`` on the GPU against the CPU
    (reduced float32, a window of 3): logits within the 5e-2 of
    :func:`reference_check`, lengths returned unchanged.  The dense
    window of slot 1 overshoots ``max_seq`` (16): those writes drop.  The
    paged window of slot 1 runs past its table: positions 12 and 13 land
    in null block 0, and no block but those the windows address changes."""
    cfg = gpu.cfg
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 3)).astype(np.int32))
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    dense_kv = torch.from_numpy(rng.standard_normal((2, L, 2, 16, Hkv, Dh), np.float32))
    pool_kv = torch.from_numpy(rng.standard_normal((2, L, 10, Hkv, 4, Dh), np.float32))
    tables = torch.tensor([[3, 7, 0], [5, 2, 9]], dtype=torch.int32)
    out = []
    for model, params, d in ((gpu, p_gpu, dev), (cpu, p_cpu, torch.device("cpu"))):
        dc = model.init_cache(2, 16)
        pc = model.init_paged_cache(2, 10, 4, 3)
        for i, key in enumerate(("k", "v")):
            dc[key].copy_(dense_kv[i])
            pc[key].copy_(pool_kv[i])
        dc["lengths"].copy_(torch.tensor([4, 14]))
        pc["lengths"].copy_(torch.tensor([3, 11]))
        pc["block_tables"].copy_(tables)
        ld, dc = model.verify_step(params, dc, toks.to(d))
        lp, pc = model.paged_verify_step(params, pc, toks.to(d))
        out.append((ld.cpu(), lp.cpu(), {k: v.cpu() for k, v in dc.items()},
                    {k: v.cpu() for k, v in pc.items()}))
    (ldg, lpg, dcg, pcg), (ldc, lpc, _, _) = out
    worst = max(_max_err(ldg, ldc), _max_err(lpg, lpc))
    changed = {key: {int(b) for b in torch.nonzero(
        (pcg[key].float() != pool_kv[i].bfloat16().float()).flatten(2).any(-1).any(0)
    ).flatten()} for i, key in enumerate(("k", "v"))}
    kept = bool(torch.equal(dcg["k"][:, 1, :14].float(),
                            dense_kv[0][:, 1, :14].bfloat16().float()))
    print(f"verify reference check (reduced f32, GPU vs CPU): max |logit diff| {worst:.3e}; "
          f"lengths {dcg['lengths'].tolist()} {pcg['lengths'].tolist()}; paged blocks "
          f"written {changed}; dense slot 1 below its length kept: {kept}")
    if not (worst <= 5e-2 and dcg["lengths"].tolist() == [4, 14]
            and pcg["lengths"].tolist() == [3, 11] and kept
            and changed == {"k": {0, 3, 7, 9}, "v": {0, 3, 7, 9}}):
        raise AssertionError("verify reference check failed")


def block128_check(dev) -> None:
    """``--block-size 128`` on the card: a reduced serve through
    ``repro_torch.launch.serve`` (bf16, paged, decode-only, prompts over
    one block) whose paged launches, at the block-128 shape key, number 2
    per decode step; then reduced float32 engines on the GPU (async and
    sync) against the CPU: greedy tokens and step clock equal."""
    flags = ["--reduced", "--requests", "6", "--slots", "3", "--max-seq", "512",
             "--max-new", "12", "--cache", "paged", "--block-size", "128",
             "--device", "cuda"]
    args = serve.build_parser().parse_args(flags)
    model, params = serve.load_model(args)
    ops.reset_launch_counts()
    res = serve.serve(args, model, params)
    cfg, st = model.cfg, res.stats
    key = ("unscaled", kernel_heads(cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                                    cfg.resolved_head_dim(), 128))
    got = ops.shape_counts()["paged_decode_attention"]
    print(f"block-128 serve (reduced, bf16): {serve.stats_line(args.requests, st)}; paged "
          f"launches {got}, expected {{{key}: {st.decode_steps * cfg.n_layers}}}")
    if not (got == {key: st.decode_steps * cfg.n_layers} and res.engine.pool.in_use == 0
            and all(r.done and len(r.out_tokens) == 12 for r in res.driver.submitted)):
        raise AssertionError("block-128 serve failed")
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    rng = np.random.default_rng(128)
    prompts = [rng.integers(1, gpu.cfg.vocab, n).astype(np.int32) for n in (150, 260, 90)]
    runs = []
    for m, p, am in ((gpu, p_gpu, True), (gpu, p_gpu, False), (cpu, p_cpu, False)):
        eng = Engine(m, p, n_slots=2, max_seq=512, cache_kind="paged", block_size=128,
                     async_mode=am)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=10) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        s_ = eng.run()
        runs.append(([r.out_tokens for r in reqs], (s_.engine_steps, s_.decode_steps)))
    print(f"block-128 reference check (reduced f32): tokens GPU async == sync == CPU: "
          f"{runs[0][0] == runs[1][0] == runs[2][0]}; step clocks {[c for _, c in runs]}")
    if not (runs[0] == runs[1] == runs[2]):
        raise AssertionError("block-128 reference check failed")


def _chi2(counts: torch.Tensor, expected: torch.Tensor) -> float:
    return float(((counts - expected) ** 2 / expected).sum())


def temperature_check(dev) -> None:
    """Sampling under graphs, reduced llama3.2-1b (bf16): the logits of 16
    random 12-token prompts (one whole-prompt prefill each) sampled at
    temperature 1, top-k 8, by a captured program (``sample_on_device``
    with its registered device generator, what every async graph runs):
    512 replays, then 512 eager draws from the same generator.
    Consecutive replays must draw different tokens (a generator the graph
    did not register would raise; one whose state the graph froze would
    repeat them); each set's per-row counts must fit the exact top-8
    distribution and the two sets each other (chi-square over 16 x 7
    degrees of freedom at least, bound: mean + 6 standard deviations).
    The support is what the sampler keeps: every token at or above a
    row's 8th largest logit (bf16 logits tie there).
    Then temperature runs of the engine through the graphs, plain and
    speculative, on the hybrid schedule: they complete, their replays
    ran, and no request repeats one token throughout."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    rng = np.random.default_rng(17)
    logits = torch.cat([m.prefill(params, torch.from_numpy(
        rng.integers(1, cfg.vocab, (1, 12))).to(dev), m.init_cache(1, 16))[0]
        for _ in range(16)]).float()
    sampler = SamplerConfig(temperature=1.0, top_k=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    prog = Program("sample", lambda inp: (sample_on_device(logits, gen, sampler),), {}, dev,
                   graphs=True, pool=torch.cuda.graph_pool_handle(), generators=(gen,))
    n = 512
    graph_draws = torch.stack([prog()[0].clone() for _ in range(n)])[1:]   # replays only
    eager_draws = torch.stack([sample_on_device(logits, gen, sampler) for _ in range(n - 1)])
    repeats = int((graph_draws[1:] == graph_draws[:-1]).all(dim=1).sum())
    keep = logits >= torch.topk(logits, 8, dim=-1).values[:, -1:]          # (16, V)
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)[keep]
    dof = int(keep.sum()) - 16
    bound = dof + 6 * (2 * dof) ** 0.5

    def counts(draws):
        return F.one_hot(draws.long(), logits.shape[-1]).sum(dim=0).float()   # (16, V)

    cg, ce = counts(graph_draws), counts(eager_draws)
    outside = int(cg[~keep].sum() + ce[~keep].sum())
    cg, ce = cg[keep], ce[keep]
    pooled = (cg + ce) / 2
    chi = {"graph": _chi2(cg, (n - 1) * probs), "eager": _chi2(ce, (n - 1) * probs),
           "graph vs eager": _chi2(cg, pooled) + _chi2(ce, pooled)}
    print(f"temperature check (reduced, T=1, top-k 8: {int(keep.sum())} kept tokens in 16 rows, "
          f"{n - 1} replays vs {n - 1} eager draws): consecutive replays equal {repeats}; "
          f"draws outside the kept tokens {outside}; chi-square (dof {dof}, bound {bound:.1f}) "
          + ", ".join(f"{k} {v:.1f}" for k, v in chi.items()))
    if repeats or outside or max(chi.values()) >= bound:
        raise AssertionError("temperature draws under graphs do not fit the distribution")
    prompts = [rng.integers(1, cfg.vocab, 10).astype(np.int32) for _ in range(6)]
    for label, extra in (("plain", {}), ("spec", dict(spec_depth=2, draft_model=m,
                                                      draft_params=m.init(5)))):
        eng = Engine(m, params, n_slots=3, max_seq=64, sampler=SamplerConfig(temperature=1.0),
                     schedule="hybrid", prefill_chunk=8, **extra)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=12) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        replays = {k: p.replays for k, p in eng.programs.items()}
        ok = (all(r.done and len(r.out_tokens) == 12 and len(set(r.out_tokens[1:])) > 1
                  for r in reqs) and sum(replays.values()) > 0)
        print(f"temperature serve through graphs ({label}): replays {replays}; "
              f"all complete, fresh tokens: {ok}")
        if not ok:
            raise AssertionError(f"temperature serve through graphs ({label}) failed")


def migration_check(dev) -> None:
    """KV block migration on the card, reduced llama3.2-1b (bf16): a
    request exported after two decode steps and imported into a second
    engine, for a bf16 pool and an fp8 pool with its scale pools.  The
    blocks the export gathers equal (``torch.equal`` on their bytes) the
    source's blocks, and the blocks the import lands equal the payload;
    decode on the destination gives the unmigrated run's tokens."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    prompt = np.random.default_rng(5).integers(1, cfg.vocab, 21).astype(np.int32)
    for kv in ("bf16", "fp8"):
        kw = dict(n_slots=2, max_seq=64, cache_kind="paged", block_size=4, kv_dtype=kv)
        solo = Engine(m, params, **kw)
        solo_req = Request(uid=0, prompt=prompt, max_new_tokens=8)
        solo.submit(solo_req)
        solo.run()
        src = Engine(m, params, **kw)
        req = Request(uid=0, prompt=prompt, max_new_tokens=8)
        src.submit(req)
        src.step()
        src.step()
        ids = list(src.manager.blocks[0])
        keys = ("k", "v", "k_scale", "v_scale") if kv == "fp8" else ("k", "v")
        before = {k: ref.byte_view(src.cache[k][:, ids]).clone() for k in keys}
        req, ticket, payload = src.export_request(0)
        dst = Engine(m, params, **kw)
        slot = dst.import_request(req, ticket, payload)
        landed = pdev.copy_blocks_out(dst.cache, dst.manager.blocks[slot][:ticket.n_blocks])
        gathered = all(torch.equal(ref.byte_view(payload[k]), before[k]) for k in keys)
        exact = all(torch.equal(ref.byte_view(landed[k]), ref.byte_view(payload[k]))
                    for k in keys)
        dst.run()
        torch.cuda.synchronize()
        print(f"migration check ({kv}, {ticket.n_blocks} blocks, leaves {sorted(payload)}): "
              f"gathered == source blocks {gathered}, landed == payload {exact}, tokens == "
              f"unmigrated run's {req.out_tokens == solo_req.out_tokens}")
        if not (gathered and exact and set(payload) == set(keys)
                and req.out_tokens == solo_req.out_tokens):
            raise AssertionError(f"migration check ({kv}) failed")


CLUSTER_COMBOS = {
    "1p+1d paged hybrid": dict(roles="1p+1d", cache_kind="paged", block_size=4,
                               schedule="hybrid", prefill_chunk=8),
    "1p+1d dense decode-only": dict(roles="1p+1d"),
    "2 mixed prefix_affinity paged hybrid": dict(route="prefix_affinity", cache_kind="paged",
                                                 block_size=4, schedule="hybrid",
                                                 prefill_chunk=8),
}


def cluster_reference_check(dev) -> None:
    """Reduced llama3.2-1b in float32, the same weights on the card and on
    the CPU: two-replica clusters (1P+1D paged hybrid, 1P+1D dense, two
    mixed replicas routed by prefix affinity), async and sync, the card's
    under CUDA graphs.  Tokens, ``ClusterStats`` and ``RouterStats`` equal
    the CPU cluster's exactly."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    rng = np.random.default_rng(23)
    doc = rng.integers(1, gpu.cfg.vocab, 12).astype(np.int32)
    prompts = [np.concatenate([doc, rng.integers(1, gpu.cfg.vocab, n).astype(np.int32)])
               if i % 2 else rng.integers(1, gpu.cfg.vocab, n + 4).astype(np.int32)
               for i, n in enumerate((3, 9, 5, 2, 7, 4, 1, 6))]
    for combo, kw in CLUSTER_COMBOS.items():
        for async_mode in (True, False):
            runs = []
            for m, p in ((gpu, p_gpu), (cpu, p_cpu)):
                cl = Cluster(m, p, 2, n_slots=3, max_seq=64, async_mode=async_mode, **kw)
                reqs = [Request(uid=i, prompt=x, max_new_tokens=6) for i, x in enumerate(prompts)]
                for r in reqs:
                    cl.submit(r)
                st = cl.run()
                runs.append(([r.out_tokens for r in reqs], dataclasses.asdict(st),
                             dataclasses.asdict(cl.router.stats)))
            (tg, sg, rg), (tc, sc, rc) = runs
            print(f"cluster reference check ({combo}, {'async' if async_mode else 'sync'}): "
                  f"rounds {sg['rounds']}, migrations {sg['migrations']}, prefix hit tokens "
                  f"{rg['prefix_hit_tokens']}; tokens, ClusterStats, RouterStats GPU == CPU: "
                  f"{tg == tc}, {sg == sc}, {rg == rc}")
            if not (tg == tc and sg == sc and rg == rc
                    and (sg["migrations"] > 0) == ("roles" in kw)):
                raise AssertionError(f"cluster reference check ({combo}) failed")


def sub_batch_check(dev) -> None:
    """``sub_batches=2`` at reduced size: bf16 under CUDA graphs (two
    stream branches in the decode graph) against the same engine eager,
    async and sync, tokens and step clock equal and the dense decode kernel
    twice per layer and step; float32 on the card against the CPU, tokens
    equal."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (5, 3, 11, 21, 4, 9)]

    def run(model, p, **kw):
        eng = Engine(model, p, n_slots=4, max_seq=64, sub_batches=2, **kw)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=8) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launch_counts()
        st = eng.run()
        return [r.out_tokens for r in reqs], st, ops.variant_counts()["decode_attention"], eng

    for async_mode in (True, False):
        (tg, sg, lg, eng), (te, se, le, _) = (run(m, params, graphs=g, async_mode=async_mode)
                                              for g in (True, False))
        want = {"unscaled": 2 * sg.decode_steps * cfg.n_layers}
        prog = eng.programs["decode"]
        # the plain engine whose decode batch is one sub-batch's 2 rows
        narrow = Engine(m, params, n_slots=2, max_seq=64, async_mode=async_mode)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=8) for i, x in enumerate(prompts)]
        for r in reqs:
            narrow.submit(r)
        narrow.run()
        tn = [r.out_tokens for r in reqs]
        print(f"sub-batch check ({'async' if async_mode else 'sync'}, bf16): graphs vs eager "
              f"tokens equal {tg == te}, stats equal {sg == se}; tokens == a 2-slot engine's "
              f"{tg == tn}; decode launches {lg} (eager {le}, expected {want}); decode graph "
              f"{prog.calls} calls/{prog.replays} replays")
        if not (tg == te == tn and sg == se and lg == le == want and prog.graph is not None):
            raise AssertionError("sub-batch check: graphs, eager and the narrow engine differ")
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    (tg, sg, _, _), (tc, sc, _, _) = run(gpu, p_gpu), run(cpu, p_cpu)
    print(f"sub-batch check (float32, GPU vs CPU): tokens equal {tg == tc}, stats equal "
          f"{sg == sc}")
    if not (tg == tc and sg == sc):
        raise AssertionError("sub-batch check: GPU and CPU differ")


def ptxas_lines(name: str) -> list[str]:
    """One line per kernel of ``csrc/<name>.cu`` from its build log
    (``-Xptxas -v``): registers, shared memory, spills."""
    lines, kern, spill = [], "?", ""
    for line in _build.build_log(name).splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEv", m.group(1))
            kern = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)[:80]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            lines.append(f"ptxas {name} {kern}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc in parallel) -> {_build.build_dir()}")
    for name in _build.sources():
        for line in ptxas_lines(name):
            print(line)

    rows = [decode_phase(dev), prefill_phase(dev), prefill_chunk_phase(dev),
            prefill_phase(dev, "int8"), prefill_phase(dev, "fp8"), prefill_f32_phase(dev),
            paged_phase(dev), paged_phase(dev, "fp8"), paged_phase(dev, "int8"),
            decode_phase(dev, draft=True), prefill_chunk_phase(dev, draft=True),
            paged_phase(dev, bs=128), paged_phase(dev, "fp8", bs=128)]
    for r in rows:
        dev_off = (f" (at a device q_offset {r['device_offset_ms']:.4f})"
                   if "device_offset_ms" in r else "")
        print(f"kernel {r['name']}: err {r['max_abs_err']:.2e} (tol {r['tol']}) "
              f"kernel {r['ms']:.4f} ms{dev_off} (events {r['event_ms']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']}")
    by_name = {r["name"]: r for r in rows}
    model, params = load_model()
    L, k = model.cfg.n_layers, SPEC_DEPTH
    Ld = serve.load_draft(serve.build_parser().parse_args(SERVE_FLAGS), model)[0].cfg.n_layers

    def draft_chunks(st):
        """The draft's prefill chunks: its steps less k + 1 decodes per window."""
        return st.draft_steps - (k + 1) * st.spec_steps

    by_path: dict[str, PathRun] = {}

    def path(label, flags, want, **kw):
        by_path[label] = serve_phase(model, params, label, flags, want, by_name, **kw)

    def dense_want(st):
        return {"decode_attention": st.decode_steps * L, "prefill_attention": st.prefills * L}

    def paged_want(st):
        return {"prefill_attention[chunk]": st.prefill_chunks * L,
                "paged_decode_attention": st.decode_steps * L}

    def tiered_want(st):
        # every decode step attends twice per layer (hot and cold windows);
        # prefill runs unscaled on the bf16 staging cache
        return {"prefill_attention[chunk]": st.prefill_chunks * L,
                "paged_decode_attention[fp8]": 2 * st.decode_steps * L}

    path("dense", [], dense_want, eager=True)
    path("paged-hybrid", PAGED_FLAGS, paged_want, eager=True)
    path("paged-tiered", TIERED_FLAGS, tiered_want, tiered=True, eager=True)
    path("paged-tiered-int8", TIERED_INT8_FLAGS, lambda st: {
        "prefill_attention": st.prefills * L,
        "paged_decode_attention[int8]": 2 * st.decode_steps * L}, tiered=True)
    # speculative: each window is k + 1 verify passes of the target (L
    # layers) and k + 1 draft decodes (Ld layers); the draft's cache is
    # prefilled in 32-token chunks at its own heads
    path("dense-spec", SPEC_FLAGS, lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * L,
        "decode_attention[draft]": st.spec_steps * (k + 1) * Ld,
        "prefill_attention": st.prefills * L,
        "prefill_attention[draft-chunk]": draft_chunks(st) * Ld}, base=by_path["dense"],
        eager=True)
    path("paged-hybrid-spec", PAGED_FLAGS + SPEC_FLAGS, lambda st: {
        "paged_decode_attention": st.spec_steps * (k + 1) * L,
        "decode_attention[draft]": st.spec_steps * (k + 1) * Ld,
        "prefill_attention[chunk]": st.prefill_chunks * L,
        "prefill_attention[draft-chunk]": draft_chunks(st) * Ld},
        base=by_path["paged-hybrid"])
    # the target as its own draft: both decode at the target's heads, the
    # draft's cache prefilled in chunks of the hybrid chunk's shape
    path("target-draft", ["--spec-depth", str(k), "--requests", "16"], lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * 2 * L,
        "prefill_attention": st.prefills * L,
        "prefill_attention[chunk]": draft_chunks(st) * L},
        base=by_path["dense"], draft=(model, params))
    # the same on the dense hybrid schedule: the target's cache is then
    # filled by the very chunk calls that fill the draft's, so every
    # drafted token should be accepted (min_accept)
    path("target-draft-hybrid", ["--spec-depth", str(k), "--requests", "16", "--schedule",
                                 "hybrid"], lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * 2 * L,
        "prefill_attention[chunk]": (st.prefill_chunks + draft_chunks(st)) * L},
        draft=(model, params), min_accept=0.99)
    # the open-loop workloads: shared documents hit the paged pool's prefix
    # cache; shared chat prefixes on the tiered pool; grown agentic turns
    path("rag", RAG_FLAGS, paged_want, open_loop=True)
    # the host tier fills (512 blocks) and then the pool preempts
    path("chat-fan", CHAT_FAN_FLAGS, tiered_want, tiered=True, open_loop=True, preempt_ok=True)
    path("agentic", AGENTIC_FLAGS, dense_want, open_loop=True)
    for label in ("rag", "chat-fan", "agentic"):
        run = by_path[label]
        pool = run.res.engine.pool.stats if label != "agentic" else None
        print(f"[{label}] workload: rounds {run.res.rounds}, resubmits "
              f"{run.res.driver.resubmits}, {_rate(run.res)}"
              + (f"; prefix hits {pool.hash_hits}, COW copies {pool.cow_copies}, spills "
                 f"{run.stats.spills}, rehydrations {run.stats.rehydrations}" if pool else ""))
    if by_path["rag"].res.engine.pool.stats.hash_hits <= 0:
        raise AssertionError("[rag] no prefix hit on the shared documents")
    if by_path["agentic"].res.driver.resubmits != 32:
        raise AssertionError("[agentic] 16 sessions x 3 turns should resubmit 32 times")
    # the cluster tier: two replicas on the one card, sharing the weights;
    # each path's tokens held to its single-engine path's by the token floor
    for label, flags, want, base, kw in (
            ("cluster-affinity", AFFINITY_FLAGS, paged_want, "rag", {}),
            ("cluster-round-robin", ROUND_ROBIN_FLAGS, paged_want, "rag", {}),
            ("disagg", DISAGG_FLAGS, paged_want, "paged-hybrid", {}),
            ("disagg-tiered", DISAGG_TIERED_FLAGS, tiered_want, "paged-tiered",
             dict(tiered=True))):
        by_path[label] = cluster_phase(model, params, label, flags, want, by_name,
                                       by_path[base], **kw)
    hit = {p: by_path[p].stats.prefix_hit_rate for p in ("cluster-affinity",
                                                          "cluster-round-robin")}
    print(f"[cluster] router prefix hit rate: prefix_affinity {hit['cluster-affinity']:.4f}, "
          f"round_robin {hit['cluster-round-robin']:.4f}")
    # sub-batch pipelining: two sub-batches of 8 rows, each on its own
    # stream inside the decode graph: the dense decode kernel twice a layer
    path("sub-batches", SUB_BATCH_FLAGS, lambda st: {
        "decode_attention": 2 * st.decode_steps * L, "prefill_attention": st.prefills * L},
        eager=True)
    # a sub-batch's decode GEMMs have 8 rows, the dense path's 16, and
    # cuBLAS sums the 8192-deep FFN-down product of 8 rows in another order
    # (1-ulp differences in ~0.2% of its outputs, which the random-weight
    # model amplifies until a near-tie flips): the plain engine whose decode
    # batch has 8 rows must give the sub-batches' tokens exactly
    path("dense-8", ["--slots", "8"], dense_want)
    sub = by_path["sub-batches"].res.driver.submitted
    agreement("sub-batches", sub, by_path["dense-8"], exact=True)
    agreement("sub-batches", sub, by_path["dense"], floor=False)
    sub_batch_phase(model, params)
    observatory_phase(model, params)
    print("phase walls: " + ", ".join(f"{p} {r.wall_s:.1f}s" for p, r in by_path.items()))
    for graphs in (True, False):
        profile_phase(model, params, "dense", [], warm_steps=4, graphs=graphs)
        profile_phase(model, params, "paged-hybrid", PAGED_FLAGS, warm_steps=48, graphs=graphs)
        # 60 steps in, the profile's 32 requests have filled the pool and begun to spill
        profile_phase(model, params, "paged-tiered", TIERED_FLAGS, warm_steps=60,
                      graphs=graphs)
        profile_phase(model, params, "dense-spec", SPEC_FLAGS, warm_steps=4, graphs=graphs)
    del model, params
    t0 = time.perf_counter()
    reference_check(dev)
    preemption_check(dev)
    host_tier_check(dev)
    spec_reference_check(dev)
    block128_check(dev)
    temperature_check(dev)
    migration_check(dev)
    cluster_reference_check(dev)
    sub_batch_check(dev)
    print(f"reduced checks: {time.perf_counter() - t0:.1f}s")
    for r in rows:
        r["launches_by_path"] = {p: run.launches.get(r["name"], 0)
                                 for p, run in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        # on no serving path: the scaled and f32 prefill variants (the
        # reference's quantized pools prefill into the bf16 staging cache;
        # float32 mode runs in the reference checks) and block size 128
        # (a --block-size the serve paths do not pass; block128_check runs
        # it at reduced size)
        r["on_main_path"] = not ((r["kernel"] == "prefill_attention"
                                  and r["variant"] != "unscaled") or "bs128" in r["name"])
        if r["on_main_path"] and not r["launches"]:
            raise AssertionError(f"{r['name']} never launched on the main paths")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
