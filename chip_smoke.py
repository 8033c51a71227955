"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds every kernel in ``src/repro_torch/kernels/csrc/`` with nvcc
   (one process per source, in parallel) and prints the build time.
3. Kernel phase: each kernel against its plain PyTorch version at the
   main path's shapes, with its time beside the plain version's, one
   ``scaled_dot_product_attention`` call on the same work (a yardstick,
   never used by the port) and the least time the card could take.
4. Serve phase: full-width llama3.2-1b with seeded random weights through
   ``repro_torch.launch.serve``: the random workload with async
   dispatch-ahead (the main path, with every launch counter zeroed
   before and read after), then again synchronously; the greedy tokens
   must be identical and each kernel must have launched once per layer
   of every prefill and decode step.
5. A profile of steady decode steps (torch.profiler), for where the
   time goes.
6. A small-input check: reduced llama3.2-1b in float32, prefill and
   decode through the kernels on the GPU against the plain path on the
   CPU, same weights.

Any failure raises (non-zero exit).  The line before the last is a JSON
object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import prefill_attention as kpre  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402
from repro_torch.serving.workload import build_workload  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20
BF16_TOL = 2e-2           # bf16 output, as tests/test_kernels.py holds the Pallas kernels
SERVE_FLAGS = ["--arch", "llama3.2-1b", "--requests", "64", "--slots", "16",
               "--max-seq", "1024", "--max-new", "64", "--workload", "random",
               "--workload-seed", "0", "--seed", "0", "--device", "cuda"]


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


def _bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------- kernel phase
def decode_phase(dev) -> dict:
    """llama3.2-1b decode attention at 16 slots, max_seq 1024, bf16."""
    B, S, Hkv, G, D = 16, 1024, 8, 4, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.tensor([1, S, S + 9, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                            700, 900, 1000, 1023], dtype=torch.int32, device=dev)
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
        raise AssertionError(f"decode_attention kernel vs plain: max err {err}")

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
        "name": "decode_attention", "route": "cuda", "source": kdec.SOURCE,
        "replaces": kdec.REPLACES, "max_abs_err": err, "tol": BF16_TOL,
        "ms": _time_ms([lambda s=s: ops.decode_attention(*s, lengths) for s in sets]),
        "plain_ms": _time_ms([lambda s=s: kdec.plain(*s, lengths) for s in sets], 10),
        "library_ms": _time_ms([lambda s=s: library(*s) for s in sets]),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 lengths={lengths.tolist()}",
    }


def prefill_phase(dev) -> dict:
    """llama3.2-1b prefill attention (Hq 32, Hkv 8, D 64, bf16, B 1) at odd
    prompt lengths, q_offset 0 (the main path) and 17."""
    Hq, Hkv, D = 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    cases, timed = [], None
    for sq, off in ((37, 0), (37, 17), (509, 17), (509, 0)):
        sk = sq + off
        q = torch.randn(1, sq, Hq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(1, sk, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(1, sk, Hkv, D, generator=gen, device=dev).bfloat16()
        out = ops.flash_attention(q, k, v, q_offset=off)
        exp = kpre.plain(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        err = _max_err(out, exp)
        if not err <= BF16_TOL:
            raise AssertionError(f"prefill_attention kernel vs plain at Sq={sq} "
                                 f"q_offset={off}: max err {err}")
        cases.append({"sq": sq, "sk": sk, "q_offset": off, "max_abs_err": err})
        timed = (q, k, v, sq, sk, off)
    q, k, v, sq, sk, off = timed          # the main path's case: q_offset 0, Sq 509

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    lib_err = _max_err(library().transpose(1, 2), kpre.plain(q, k, v))
    pairs = sum(min(sk, off + i + 1) for i in range(sq))    # visible (q, k) pairs
    flops = 4 * pairs * Hq * D
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": "prefill_attention", "route": "cuda", "source": kpre.SOURCE,
        "replaces": kpre.REPLACES,
        "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": BF16_TOL,
        "ms": _time_ms([lambda: ops.flash_attention(q, k, v)]),
        "plain_ms": _time_ms([lambda: kpre.plain(q, k, v)], 10),
        "library_ms": _time_ms([library]), "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "f32_fma_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "shape": f"B=1 Sq=Sk={sq} Hq={Hq} Hkv={Hkv} D={D} bf16 causal q_offset=0",
        "cases": cases,
    }


# ------------------------------------------------------------ serve phase
def serve_phase(dev):
    args = serve.build_parser().parse_args(SERVE_FLAGS + ["--async", "on"])
    t0 = time.perf_counter()
    model, params = serve.load_model(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"serve: {cfg.name} n_params={model.n_params()} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"weights {time.perf_counter() - t0:.1f}s")
    warm = serve.build_parser().parse_args(SERVE_FLAGS + ["--requests", "4"])
    serve.serve(warm, model, params)           # warm-up: cuBLAS handles, allocator

    ops.reset_launch_counts()
    res = serve.serve(args, model, params)     # the main path
    launches = ops.launch_counts()
    for line in serve.report(args, res):
        print(line)
    st = res.stats
    want = {"prefill_attention": st.prefills * cfg.n_layers,
            "decode_attention": st.decode_steps * cfg.n_layers}
    print(f"launches: {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected {want}")
    reqs = res.driver.submitted
    for r in reqs:
        if not (r.done and len(r.out_tokens) == args.max_new
                and all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"request {r.uid}: done={r.done} "
                                 f"tokens={len(r.out_tokens)}")

    sync_args = serve.build_parser().parse_args(SERVE_FLAGS + ["--async", "off"])
    sync = serve.serve(sync_args, model, params)
    for line in serve.report(sync_args, sync):
        print(line)
    same = [a.out_tokens == b.out_tokens for a, b in zip(reqs, sync.driver.submitted)]
    print(f"sync vs async greedy: {sum(same)}/{len(same)} requests token-identical")
    if not all(same):
        raise AssertionError("sync and async greedy tokens differ")
    return launches, model, params


def profile_phase(model, params, n_steps: int = 8) -> None:
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``n_steps`` async steps with all 16 slots decoding.  Prints wall time
    per step, device busy time per step and the top kernels; reports "not
    measured" if the profiler sees no device time."""
    args = serve.build_parser().parse_args(SERVE_FLAGS + ["--max-new", "40"])
    eng = Engine(model, params, n_slots=args.slots, max_seq=args.max_seq,
                 sampler=SamplerConfig(), async_mode=True)
    for i, arr in enumerate(build_workload("random", args.slots, vocab=model.cfg.vocab,
                                           max_seq=args.max_seq, max_new=args.max_new,
                                           seed=1)):
        eng.submit(Request(uid=i, prompt=arr.prompt, max_new_tokens=arr.max_new_tokens))
    for _ in range(4):                      # admit all, reach steady decode
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    eng.run()
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    if not rows:
        print(f"profile: wall {wall_ms:.2f} ms/decode step; device time not measured "
              "(the profiler saw no device activity)")
        return
    print(f"profile: wall {wall_ms:.2f} ms/decode step, device busy {busy_ms:.2f} "
          f"ms/step ({busy_ms / wall_ms:.0%}), {sum(e.count for e in rows) // n_steps} "
          f"device ops/step, batch {args.slots}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
              f"{e.count // n_steps:5d}x  {e.key[:90]}")


def reference_check(dev) -> None:
    """Reduced llama3.2-1b in float32: kernels on the GPU vs the plain path
    on the CPU, same weights, prefill + 4 decode steps.  Tolerance 5e-2 on
    logits: the plain decode path rounds p to the bf16 cache dtype before
    P·V (as the JAX reference does), the kernel keeps it in f32."""
    cfg = reduce_config("llama3.2-1b").with_overrides(dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    p_gpu = gpu.init(seed=3)
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
             for k, v in p_gpu.items()}
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(1, cfg.vocab, (2, 29), generator=gen)
    caches = gpu.init_cache(2, 64), cpu.init_cache(2, 64)
    lg, _ = gpu.prefill(p_gpu, prompt.to(dev), caches[0])
    lc, _ = cpu.prefill(p_cpu, prompt, caches[1])
    worst = _max_err(lg.cpu(), lc)
    for _ in range(4):
        tok = lc.argmax(-1).to(torch.int32)
        lg, _ = gpu.decode_step(p_gpu, caches[0], tok.to(dev))
        lc, _ = cpu.decode_step(p_cpu, caches[1], tok)
        worst = max(worst, _max_err(lg.cpu(), lc))
    print(f"reference check (reduced f32, GPU kernels vs CPU plain): "
          f"max |logit diff| {worst:.3e}")
    if not worst <= 5e-2:
        raise AssertionError(f"GPU vs CPU logits differ by {worst}")


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
        for line in _build.build_log(name).splitlines():
            if "registers" in line:
                print(f"ptxas {name}: {line.split(':', 1)[1].strip()}")

    rows = [decode_phase(dev), prefill_phase(dev)]
    for r in rows:
        print(f"kernel {r['name']}: err {r['max_abs_err']:.2e} (tol {r['tol']}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"sdpa {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) at {r['shape']}")
    launches, model, params = serve_phase(dev)
    profile_phase(model, params)
    del model, params
    reference_check(dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
