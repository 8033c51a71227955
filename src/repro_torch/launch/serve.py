"""End-to-end serving driver: continuous batching on one GPU.

  python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 64 --slots 16 --max-seq 1024 --max-new 64

  python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 64 --slots 16 --max-seq 1024 --max-new 64 \\
      --cache paged --schedule hybrid --blocks 385

  python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests 64 --slots 16 --max-seq 1024 --max-new 64 \
      --cache paged --schedule hybrid --kv-dtype fp8 --host-blocks 512 --blocks 129

  python -m repro_torch.launch.serve --arch llama3.2-1b --spec-depth 2 \
      --requests 64 --slots 16 --max-seq 1024 --max-new 64

Counterpart of ``repro.launch.serve`` for the dense per-slot KV cache
and the paged block pool (``--cache``, ``--block-size``, ``--blocks``),
tiered KV on the pool (``--kv-dtype fp8|int8`` stores it quantized,
``--host-blocks`` adds the host tier that cold blocks spill to), the
decode-only and hybrid chunked-prefill schedules (``--schedule``,
``--prefill-chunk``, ``--token-budget``), speculative decoding
(``--spec-depth K``: a draft, ``--draft ARCH`` at reduced size, default
a reduced ``--arch``, proposes K tokens per slot and step and the target
verifies K+1 positions; greedy output is token-identical to plain
decoding), the ``random`` workload, greedy sampling (or ``--sample
temperature|top-k``) and the async dispatch-ahead engine (``--async
off`` for the synchronous one), each dispatch kind one CUDA graph
(``--graphs off`` runs them eagerly).  Weights are random, drawn from
``--seed`` on the device; the draft's from seed 1.  The run is on the
GPU; ``--device cpu`` runs the plain PyTorch path (with ``--reduced``,
the test scale).  It prints the reference's stats, ``spec:``, latency,
``pool:`` and ``kv tier:`` lines; the balancer line, telemetry and
cluster flags arrive with later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.engine import Engine, EngineStats
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.workload import WORKLOADS, WorkloadDriver, build_workload


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--async", dest="async_mode", choices=("on", "off"), default="on",
                    help="on: dispatch-ahead pipeline with on-device sampling; "
                         "off: synchronous (greedy token-identical)")
    ap.add_argument("--sample", choices=("greedy", "temperature", "top-k"),
                    default=None,
                    help="sampling mode; default: greedy, or top-k when "
                         "--temperature > 0 is passed")
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per physical KV block")
    ap.add_argument("--blocks", type=int, default=None,
                    help="paged: pool size incl. null block "
                         "(default: dense-equivalent budget)")
    ap.add_argument("--kv-dtype", choices=("bf16", "fp8", "int8"), default="bf16",
                    help="paged: KV block storage dtype; fp8/int8 store quantized "
                         "blocks with per-vector f32 scales")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="paged: host-tier KV blocks; cold blocks spill here instead "
                         "of forcing preemption, and a spilled sequence keeps "
                         "decoding over its hot and cold windows (lse-merged)")
    ap.add_argument("--schedule", choices=("decode-only", "hybrid"),
                    default="decode-only",
                    help="hybrid: fuse chunked prefill into decode steps")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="hybrid: max prompt tokens prefilled per step")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="hybrid: per-step token budget (default: slots + prefill_chunk)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per decode step "
                         "(0 = off); each step verifies k+1 positions")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="draft architecture for --spec-depth > 0, always at reduced "
                         "size with the target's vocab (default: --arch)")
    ap.add_argument("--workload", choices=WORKLOADS, default="random")
    ap.add_argument("--workload-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--graphs", choices=("on", "off"), default=None,
                    help="one CUDA graph per dispatch kind, replayed each step "
                         "(default: on for a CUDA device; the CPU runs eagerly)")
    return ap


def make_sampler(args) -> tuple[str, SamplerConfig]:
    mode = args.sample
    if mode is None:
        mode = "greedy" if not args.temperature else "top-k"
    if mode == "greedy":
        return mode, SamplerConfig()
    # an explicit sampling mode must sample: temperature 0 would be greedy
    temp = args.temperature if args.temperature else 1.0
    return mode, SamplerConfig(temperature=temp,
                               top_k=args.top_k if mode == "top-k" else 0)


def load_model(args) -> tuple[Model, dict]:
    cfg = reduce_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, args.device)
    return model, model.init(args.seed)


@dataclasses.dataclass
class ServeResult:
    engine: Engine
    driver: WorkloadDriver
    rounds: int
    wall_s: float

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats


def load_draft(args, model: Model) -> tuple[Model, dict]:
    """The draft of ``--spec-depth``: ``--draft`` (default ``--arch``) at
    reduced size with the target's vocab, on the target's device, weights
    from seed 1."""
    draft = build_model(reduce_config(args.draft or args.arch, vocab=model.cfg.vocab),
                        model.device)
    return draft, draft.init(1)


def make_engine(args, model: Model, params: dict, draft=None) -> Engine:
    """A fresh engine configured by ``args``; ``draft`` (model, params) is
    built by :func:`load_draft` when ``--spec-depth`` asks for one and it
    is not given."""
    _, sampler = make_sampler(args)
    spec = {}
    if args.spec_depth:
        d_model, d_params = draft or load_draft(args, model)
        spec = dict(spec_depth=args.spec_depth, draft_model=d_model, draft_params=d_params)
    return Engine(model, params, n_slots=args.slots, max_seq=args.max_seq,
                  sampler=sampler, async_mode=args.async_mode == "on",
                  seed=args.seed, cache_kind=args.cache, block_size=args.block_size,
                  n_blocks=args.blocks, kv_dtype=args.kv_dtype,
                  host_blocks=args.host_blocks, schedule=args.schedule,
                  prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                  graphs=None if args.graphs is None else args.graphs == "on", **spec)


def serve(args, model: Model, params: dict, draft=None) -> ServeResult:
    """Run the workload of ``args`` through a fresh engine."""
    eng = make_engine(args, model, params, draft)
    arrivals = build_workload(args.workload, args.requests, vocab=model.cfg.vocab,
                              max_seq=args.max_seq, max_new=args.max_new,
                              seed=args.workload_seed)
    driver = WorkloadDriver(eng, arrivals)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    rounds = driver.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return ServeResult(eng, driver, rounds, time.perf_counter() - t0)


def stats_line(n_requests: int, stats: EngineStats) -> str:
    return (f"requests={n_requests} prefills={stats.prefills} "
            f"prefill_chunks={stats.prefill_chunks} "
            f"boundary_packs={stats.boundary_packs} "
            f"decode_steps={stats.decode_steps} "
            f"engine_steps={stats.engine_steps} "
            f"generated={stats.generated} peak_active={stats.peak_active}")


def report(args, res: ServeResult) -> list[str]:
    mode, sampler = make_sampler(args)
    s = res.stats
    lines = [
        f"mode: async={args.async_mode} sample={mode} "
        f"(T={sampler.temperature} top_k={sampler.top_k})",
        f"workload: {args.workload} seed={args.workload_seed} "
        f"submitted={len(res.driver.submitted)} resubmits=0 rounds={res.rounds}",
        stats_line(len(res.driver.submitted), s),
        *([f"spec: depth={args.spec_depth} accept_rate={s.acceptance_rate:.2f} "
           f"drafted={s.drafted_tokens} accepted={s.accepted_tokens} "
           f"spec_steps={s.spec_steps}"] if args.spec_depth else []),
        f"latency: TTFT mean {s.mean_ttft_steps:.1f} "
        f"p50 {s.ttft_percentile(50):.0f} p99 {s.ttft_percentile(99):.0f} "
        f"engine steps, {s.tokens_per_step:.2f} tokens/step",
        f"wall {res.wall_s:.2f}s -> {s.generated / res.wall_s:.1f} tok/s "
        f"(batch efficiency {s.generated / max(s.decode_steps * args.slots, 1):.0%}) "
        f"device={res.engine.device} graphs={'on' if res.engine.graphs else 'off'}",
    ]
    if args.cache == "paged":
        lines.append(f"pool: {res.engine.pool.stats} kv_bytes={res.engine.kv_bytes()}")
        if args.host_blocks:
            lines.append(f"kv tier: spills={s.spills} rehydrations={s.rehydrations} "
                         f"host_peak={res.engine.pool.stats.host_peak_in_use}"
                         f"/{args.host_blocks} blocks")
    return lines


def main(argv=None):
    args = build_parser().parse_args(argv)
    model, params = load_model(args)
    for line in report(args, serve(args, model, params)):
        print(line)


if __name__ == "__main__":
    main()
