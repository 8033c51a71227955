"""Time the port's attention kernels of one source tree on the GPU.

  python3 scripts/torch_kernel_ab.py [SRC_DIR] [--label NAME]

Imports ``repro_torch`` from SRC_DIR (default: this checkout's ``src``),
builds its kernels, checks each against its plain version and prints the
card's name and power limit, then one JSON line with three times per
call of each wrapper: ``event_ms``, CUDA events around 200 back-to-back
calls (which measures the host's dispatch instead once a kernel is faster
than the wrapper's Python), ``device_ms``, the same calls queued behind a
spin kernel so that the events time the device alone, and ``host_ms``,
the median over 21 bursts of 50 back-to-back calls of the host's clock
per call, each burst ending in a synchronize (the wrapper's dispatch
whenever that exceeds the device time, as it does once a kernel is
faster than the wrapper's Python); inputs rotated
through enough copies to exceed the 50 MB L2, at ``chip_smoke.py``'s
shapes — dense
decode at the serve shape, flash prefill over a whole prompt (Sq = Sk =
509), at the hybrid chunk shape (32 queries at q_offset 192 against the
1024-position staging stripe) and with int8 and fp8 K/V, and paged decode
at the serve shape over a bf16, an fp8 and an int8 pool, plus the tiered
pair of one layer over the fp8 pool: the hot window (``starts`` at each
row's cold prefix, lse out) and the cold call of a step with nothing
spilled (every window empty); and the training pair at both train shapes
(llama3.2-1b's B 8, S 1024, Hq 32, Hkv 8, D 64 and minicpm-2b's B 4, Hq =
Hkv = 36): the flash forward with its lse and the flash backward (held to
2e-2 of max(1, |plain|)), with SDPA's causal forward + backward through
autograd on the same tensors timed beside them as the yardstick.  To
compare two versions of the kernels, run it on
both trees in turns (A, B, B, A) on one card, back to back: the inputs
are the same, made from fixed seeds.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

L2_BYTES = 50 * 2**20
LENGTHS = [1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700, 900, 1000, 1023]


def time_ms(fns, iters: int = 200) -> float:
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


def device_ms(fns, iters: int = 60) -> float:
    """Device time of one call: the calls are queued behind a spin kernel
    (``torch.cuda._sleep``), so the events around them time the device
    alone; the spin doubles until the host had queued every call before
    the device reached the first."""
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
    raise RuntimeError("device_ms: the host could not queue the calls ahead of the device")


def host_ms(fns, bursts: int = 21, calls: int = 50) -> float:
    """Median over ``bursts`` of the host's clock per call across
    ``calls`` back-to-back calls, synchronized at the end of each burst."""
    per_call = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(per_call)


def copies(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / nbytes))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device visible")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ops, ref

    _build.build_all()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    times, dtimes, htimes, errs = {}, {}, {}, {}

    def timed(name, fns):
        times[name], dtimes[name], htimes[name] = time_ms(fns), device_ms(fns), host_ms(fns)

    # dense decode, serve shape
    B, S, Hkv, G, D = 16, 1024, 8, 4, 64
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    sets = [(randn(B, Hkv * G, D).bfloat16(), randn(B, S, Hkv, D).bfloat16(),
             randn(B, S, Hkv, D).bfloat16()) for _ in range(copies(2 * B * S * Hkv * D * 2))]
    errs["decode"] = float((ops.decode_attention(*sets[0], lengths).float()
                            - ref.naive_decode_attention(*sets[0], lengths).float()).abs().max())
    timed("decode", [lambda s=s: ops.decode_attention(*s, lengths) for s in sets])

    # flash prefill: whole prompt, chunk, scaled
    Hq = 32
    for name, sq, sk, off, kv in (("prefill", 509, 509, 0, None),
                                  ("prefill_chunk", 32, 1024, 192, None),
                                  ("prefill_int8", 509, 509, 0, "int8"),
                                  ("prefill_fp8", 509, 509, 0, "fp8")):
        sets = []
        for _ in range(copies(2 * sk * Hkv * D * 2)):
            q = randn(1, sq, Hq, D).bfloat16()
            k, v = randn(1, sk, Hkv, D), randn(1, sk, Hkv, D)
            if kv is None:
                sets.append((q, k.bfloat16(), v.bfloat16(), None, None))
            else:
                (kq, ks), (vq, vs) = ref.kv_quantize(k, kv), ref.kv_quantize(v, kv)
                sets.append((q, kq, vq, ks, vs))

        def call(fn, q, k, v, ks, vs, off=off):
            return fn(q, k, v, q_offset=off, k_scale=ks, v_scale=vs)

        errs[name] = float((call(ops.flash_attention, *sets[0]).float()
                            - call(ref.naive_attention, *sets[0]).float()).abs().max())
        timed(name, [lambda s=s: call(ops.flash_attention, *s) for s in sets])

    # paged decode, serve shape: bf16, fp8 and int8 pools; the tiered pair
    bs, MB = 16, 64
    N = B * MB + 1
    tables = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(5))[:B * MB] + 1)
    tables = tables.view(B, MB).to(torch.int32).to(dev)
    cold = (lengths.clamp(max=MB * bs) // 3 // bs * bs).to(torch.int32)   # whole blocks
    empty = torch.zeros_like(lengths)
    for kv in (None, "fp8", "int8"):
        elem = 2 if kv is None else 1
        sets = []
        for _ in range(copies(2 * N * Hkv * bs * D * elem)):
            q, k, v = randn(B, Hkv * G, D).bfloat16(), randn(N, Hkv, bs, D), randn(N, Hkv, bs, D)
            if kv is None:
                sets.append((q, k.bfloat16(), v.bfloat16(), None, None))
            else:
                (kq, ks), (vq, vs) = ref.kv_quantize(k, kv), ref.kv_quantize(v, kv)
                sets.append((q, kq, vq, ks, vs))

        def call(fn, q, k, v, ks, vs, n=lengths, **kw):
            return fn(q, k, v, tables, n, k_scale=ks, v_scale=vs, **kw)

        name = "paged" if kv is None else f"paged_{kv}"
        errs[name] = float((call(ops.paged_decode_attention, *sets[0]).float()
                            - call(ref.paged_decode_attention, *sets[0]).float()).abs().max())
        timed(name, [lambda s=s: call(ops.paged_decode_attention, *s) for s in sets])
        if kv != "fp8":
            continue
        hot = dict(starts=cold, return_lse=True)
        got, exp = (call(fn, *sets[0], **hot) for fn in (ops.paged_decode_attention,
                                                         ref.paged_decode_attention))
        errs["tier_hot"] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, exp))
        timed("tier_hot", [lambda s=s: call(ops.paged_decode_attention, *s, **hot)
                           for s in sets])
        out, lse = call(ops.paged_decode_attention, *sets[0], n=empty, return_lse=True)
        errs["tier_cold_empty"] = (float(out.float().abs().max())
                                   if float(lse.max()) <= -1e30 else float("inf"))
        timed("tier_cold_empty", [lambda s=s: call(ops.paged_decode_attention, *s, n=empty,
                                                   return_lse=True) for s in sets])

    # training: the flash forward with lse and the flash backward, SDPA beside them
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import prefill_attention as kpre

    for tag, (B, S, Hq, Hkv, D) in (("", (8, 1024, 32, 8, 64)),
                                    ("_minicpm", (4, 1024, 36, 36, 64))):
        q, do = randn(B, S, Hq, D).bfloat16(), randn(B, S, Hq, D).bfloat16()
        k, v = randn(B, S, Hkv, D).bfloat16(), randn(B, S, Hkv, D).bfloat16()
        out, lse = kpre.kernel(q, k, v, return_lse=True)
        got = kbwd.kernel(q, k, v, out, do, lse)
        want = kbwd.plain(q, k, v, out, do, lse)
        errs[f"flash_bwd{tag}"] = max(
            float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1)).max())
            for a, b in zip(got, want))
        del got, want
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        do_t = do.transpose(1, 2)

        def sdpa(qs=qs, ks=ks, vs=vs, do_t=do_t):
            o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                                 enable_gqa=True)
            return torch.autograd.grad(o, (qs, ks, vs), do_t)

        timed(f"train_lse{tag}", [lambda q=q, k=k, v=v: kpre.kernel(q, k, v, return_lse=True)])
        timed(f"flash_bwd{tag}", [lambda a=(q, k, v, out, do, lse): kbwd.kernel(*a)])
        timed(f"sdpa_fwd_bwd{tag}", [sdpa])
        del q, k, v, do, out, lse, qs, ks, vs, do_t

    bad = {k: e for k, e in errs.items() if not e <= 2e-2}
    if bad:
        raise SystemExit(f"torch_kernel_ab: kernels disagree with their plain versions: {bad}")
    print(json.dumps({"label": args.label or args.src, "card": card, "event_ms": times,
                      "host_ms": htimes,
                      "device_ms": dtimes, "max_abs_err": errs}))


if __name__ == "__main__":
    main()
