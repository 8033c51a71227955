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

  python -m repro_torch.launch.serve --arch llama3.2-1b --replicas 2 \
      --role-map 1p+1d --requests 64 --slots 16 --max-seq 1024 --max-new 64 \
      --cache paged --schedule hybrid --blocks 385

Counterpart of ``repro.launch.serve`` for the dense per-slot KV cache
and the paged block pool (``--cache``, ``--block-size``, ``--blocks``),
tiered KV on the pool (``--kv-dtype fp8|int8`` stores it quantized,
``--host-blocks`` adds the host tier that cold blocks spill to), the
decode-only and hybrid chunked-prefill schedules (``--schedule``,
``--prefill-chunk``, ``--token-budget``), speculative decoding
(``--spec-depth K``: a draft, ``--draft ARCH`` at reduced size, default
a reduced ``--arch``, proposes K tokens per slot and step and the target
verifies K+1 positions; greedy output is token-identical to plain
decoding), greedy sampling (or ``--sample temperature|top-k``) and the
async dispatch-ahead engine (``--async off`` for the synchronous one),
each dispatch kind one CUDA graph (``--graphs off`` runs them eagerly),
sub-batch pipelining (``--sub-batches n``: the dense decode step as n
sub-batches, each on its own CUDA stream inside the one graph), and the
cluster tier: ``--replicas N`` engine replicas behind one global queue
(``--route round_robin|least_loaded|prefix_affinity``), disaggregated by
``--role-map`` (``1p+1d``, ``2p+2d+1m``, ``prefill,decode``: prompts
prefill on prefill-role replicas and their KV blocks migrate to a
decode-role one, with ``--decode-slots`` slots there).  Every replica
runs on the one ``--device`` and shares the weights.
Weights are random, drawn from ``--seed`` on the device; the draft's
from seed 1.  The run is on the GPU; ``--device cpu`` runs the plain
PyTorch path (with ``--reduced``, the test scale).

Observability, with the reference's flags and defaults:

* ``--workload {random,poisson,bursty,chat-fan,rag,agentic}`` picks the
  seeded arrival process (``--arrival-rate``, ``--fan``, ``--turns``,
  ``--workload-seed`` shape it);
* ``--trace OUT.json`` writes a Perfetto/Chrome trace of request spans
  and the per-dispatch step timeline; ``--metrics-out OUT.json`` the
  metrics-registry snapshot;
* ``--slo-ttft N`` / ``--slo-tpot M`` declare engine-step SLO targets
  (attainment and goodput lines);
* ``--profile N`` fences every Nth dispatch on the device and joins its
  wall time with the analytic cost model into measured MFU/MBU against
  ``--profile-device``'s peaks (default ``H100-SXM``; default N: 8 with
  ``--trace``, else off);
* ``--dashboard N`` prints a terminal snapshot every N rounds.

It prints the reference's ``workload:``, stats, ``spec:``, latency,
``pool:``, ``kv tier:``, SLO and ``measured`` lines, and for a cluster its
``cluster:``, ``disagg:`` and ``pool[r{i}]:`` lines; the balancer line
comes with multi-device placement.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.oi import DEVICES
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.cluster import ROUTE_POLICIES, Cluster, parse_roles
from repro_torch.serving.engine import Engine, EngineStats
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.telemetry import (SLOMonitor, Tracer, cluster_registry, engine_registry,
                                           make_profiler, render_dashboard, write_metrics,
                                           write_trace)
from repro_torch.serving.telemetry.profiler import DEFAULT_DEVICE
from repro_torch.serving.workload import WORKLOADS, WorkloadDriver, build_workload


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--sub-batches", type=int, default=1,
                    help="dense decode-only: run each decode step as n sub-batches, "
                         "each on its own CUDA stream")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the shared global queue")
    ap.add_argument("--route", choices=ROUTE_POLICIES, default="round_robin",
                    help="replica routing policy (with --replicas > 1)")
    ap.add_argument("--role-map", default=None, metavar="SPEC",
                    help="disaggregated replica roles: shorthand like '1p+1d' / "
                         "'2p+2d+1m' or a comma list like 'prefill,decode' "
                         "(default: all mixed)")
    ap.add_argument("--decode-slots", type=int, default=None,
                    help="slot count override for decode-role replicas (default: "
                         "--slots; their paged block budget scales along)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record request spans + step timeline and write a "
                         "Perfetto/Chrome-trace JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="write the metrics-registry snapshot as flat JSON")
    ap.add_argument("--workload", choices=WORKLOADS, default="random",
                    help="arrival-process shape (random: every request at round 0)")
    ap.add_argument("--workload-seed", type=int, default=0,
                    help="seed for the workload generator (same seed = "
                         "byte-identical schedule)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="open-loop arrival rate in requests/round for "
                         "poisson/bursty/chat-fan/rag/agentic workloads")
    ap.add_argument("--fan", type=int, default=4,
                    help="chat-fan: requests sharing each prompt prefix")
    ap.add_argument("--turns", type=int, default=3,
                    help="agentic: total turns per session (each turn "
                         "resubmits with the prior output as grown prefix)")
    ap.add_argument("--slo-ttft", type=int, default=None, metavar="STEPS",
                    help="TTFT SLO target in engine steps: attainment/goodput "
                         "report and slo_breach trace marks")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="STEPS",
                    help="per-output-token SLO target in engine steps")
    ap.add_argument("--profile", type=int, default=None, metavar="N",
                    help="fence + wall-clock every Nth dispatch and join with "
                         "the analytic cost model into measured MFU/MBU/bandwidth "
                         "(1: every dispatch; 0: off; default: 8 with --trace, "
                         "else off)")
    ap.add_argument("--profile-device", choices=sorted(DEVICES), default=DEFAULT_DEVICE,
                    help="device peaks used for measured MFU/MBU")
    ap.add_argument("--dashboard", type=int, default=0, metavar="N",
                    help="print a terminal snapshot every N driver rounds")
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
    serv: Engine | Cluster              # what the workload driver played against
    driver: WorkloadDriver
    rounds: int
    wall_s: float
    tracer: Tracer | None = None
    slo: SLOMonitor | None = None
    profiler: object = None

    @property
    def cluster(self) -> Cluster | None:
        return self.serv if isinstance(self.serv, Cluster) else None

    @property
    def engine(self) -> Engine:
        """The engine, or a cluster's first replica."""
        return self.serv.engines[0] if self.cluster else self.serv

    @property
    def stats(self):
        """The engine's :class:`EngineStats`, or the cluster's
        :class:`ClusterStats`."""
        return self.serv.stats() if self.cluster else self.serv.stats


def load_draft(args, model: Model) -> tuple[Model, dict]:
    """The draft of ``--spec-depth``: ``--draft`` (default ``--arch``) at
    reduced size with the target's vocab, on the target's device, weights
    from seed 1."""
    draft = build_model(reduce_config(args.draft or args.arch, vocab=model.cfg.vocab),
                        model.device)
    return draft, draft.init(1)


def make_telemetry(args):
    """``(tracer, slo, profiler)`` of ``args``: an SLO target implies a
    tracer (its hooks drive the monitor) even without ``--trace``."""
    slo = None
    if args.slo_ttft is not None or args.slo_tpot is not None:
        slo = SLOMonitor(ttft_target=args.slo_ttft, tpot_target=args.slo_tpot)
    tracer = Tracer(wall=True, slo=slo) if (args.trace or slo) else None
    sample_every = args.profile
    if sample_every is None:
        sample_every = 8 if args.trace else 0
    return tracer, slo, make_profiler(sample_every, device=args.profile_device)


def engine_kwargs(args, model: Model, draft=None) -> dict:
    """The engine configuration of ``args``; ``draft`` (model, params) is
    built by :func:`load_draft` when ``--spec-depth`` asks for one and it
    is not given."""
    _, sampler = make_sampler(args)
    spec = {}
    if args.spec_depth:
        d_model, d_params = draft or load_draft(args, model)
        spec = dict(spec_depth=args.spec_depth, draft_model=d_model, draft_params=d_params)
    return dict(n_slots=args.slots, max_seq=args.max_seq, sampler=sampler,
                sub_batches=args.sub_batches, async_mode=args.async_mode == "on",
                seed=args.seed, cache_kind=args.cache, block_size=args.block_size,
                n_blocks=args.blocks, kv_dtype=args.kv_dtype,
                host_blocks=args.host_blocks, schedule=args.schedule,
                prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                graphs=None if args.graphs is None else args.graphs == "on", **spec)


def make_engine(args, model: Model, params: dict, draft=None, tracer=None,
                profiler=None) -> Engine:
    """A fresh engine configured by ``args``."""
    return Engine(model, params, tracer=tracer, profiler=profiler,
                  **engine_kwargs(args, model, draft))


def make_server(args, model: Model, params: dict, draft=None, tracer=None,
                profiler=None) -> Engine | Cluster:
    """A fresh engine, or with ``--replicas`` > 1 a cluster of them, every
    replica on the model's device, sharing ``params``."""
    if args.replicas <= 1:
        return make_engine(args, model, params, draft, tracer, profiler)
    roles = parse_roles(args.role_map, args.replicas) if args.role_map else None
    role_kw = {"decode": {"n_slots": args.decode_slots}} if args.decode_slots else None
    return Cluster(model, params, args.replicas, route=args.route, tracer=tracer,
                   profiler=profiler, roles=roles, role_kw=role_kw,
                   **engine_kwargs(args, model, draft))


def serve(args, model: Model, params: dict, draft=None) -> ServeResult:
    """Run the workload of ``args`` through a fresh engine or cluster."""
    tracer, slo, profiler = make_telemetry(args)
    serv = make_server(args, model, params, draft, tracer,
                      profiler if profiler.enabled else None)
    arrivals = build_workload(args.workload, args.requests, vocab=model.cfg.vocab,
                              max_seq=args.max_seq, max_new=args.max_new,
                              seed=args.workload_seed, rate=args.arrival_rate,
                              fan=args.fan, turns=args.turns)
    on_round = None
    if args.dashboard:
        def on_round(r, _every=args.dashboard):
            if r % _every == 0:
                print(render_dashboard(serv, r, slo=slo, profiler=profiler))
    driver = WorkloadDriver(serv, arrivals, vocab=model.cfg.vocab, max_seq=args.max_seq,
                            seed=args.workload_seed, on_round=on_round)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    rounds = driver.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return ServeResult(serv, driver, rounds, time.perf_counter() - t0, tracer, slo, profiler)


def registry(args, res: ServeResult):
    """The one metrics registry every reported number is read from."""
    if res.cluster:
        reg = cluster_registry(res.stats)
    else:
        reg = engine_registry(res.stats,
                              res.engine.pool.stats if args.cache == "paged" else None)
    if res.slo is not None:
        res.slo.register(reg, elapsed=res.rounds)
    if res.profiler.enabled:
        res.profiler.register(reg)
    return reg


def stats_line(n_requests: int, stats: EngineStats) -> str:
    return (f"requests={n_requests} prefills={stats.prefills} "
            f"prefill_chunks={stats.prefill_chunks} "
            f"boundary_packs={stats.boundary_packs} "
            f"decode_steps={stats.decode_steps} "
            f"engine_steps={stats.engine_steps} "
            f"generated={stats.generated} peak_active={stats.peak_active}")


def cluster_lines(args, res: ServeResult, snap: dict) -> list[str]:
    """The reference's lines for a cluster: ``cluster:``, the summary,
    ``disagg:`` (when anything migrated), latency, wall and one
    ``pool[r{i}]:`` per replica."""
    cl, s = res.cluster, res.stats
    roles = " roles=" + ",".join(cl.roles) if args.role_map else ""
    lines = [f"cluster: replicas={args.replicas} route={args.route}{roles}",
             f"requests={len(res.driver.submitted)} {s.summary()}"]
    if s.migrations:
        lines.append(f"disagg: migrations={s.migrations} refold_moves={s.refold_moves} "
                     f"ttft_rounds mean {s.mean_ttft_rounds:.1f} "
                     f"p99 {s.ttft_rounds_percentile(99):.0f}")
    lines += [
        f"latency: TTFT mean {snap['mean_ttft_steps']:.1f} "
        f"p50 {snap['ttft_steps_p50']:.0f} p99 {snap['ttft_steps_p99']:.0f} engine steps, "
        f"per-token p99 {snap['per_token_steps_p99']:.2f} steps",
        f"wall {res.wall_s:.2f}s -> {s.generated / res.wall_s:.1f} tok/s "
        f"device={res.engine.device} graphs={'on' if res.engine.graphs else 'off'}",
    ]
    if args.cache == "paged":
        lines += [f"pool[r{i}]: {e.pool.stats}" for i, e in enumerate(cl.engines)]
    return lines


def report(args, res: ServeResult) -> list[str]:
    mode, sampler = make_sampler(args)
    s = res.stats
    snap = registry(args, res).snapshot()
    lines = [
        f"mode: async={args.async_mode} sample={mode} "
        f"(T={sampler.temperature} top_k={sampler.top_k})",
        f"workload: {args.workload} seed={args.workload_seed} "
        f"submitted={len(res.driver.submitted)} resubmits={res.driver.resubmits} "
        f"rounds={res.rounds}",
    ]
    if res.cluster:
        return lines + cluster_lines(args, res, snap) + telemetry_lines(res)
    lines += [
        stats_line(len(res.driver.submitted), s),
        *([f"spec: depth={args.spec_depth} accept_rate={s.acceptance_rate:.2f} "
           f"drafted={s.drafted_tokens} accepted={s.accepted_tokens} "
           f"spec_steps={s.spec_steps}"] if args.spec_depth else []),
        f"latency: TTFT mean {snap['mean_ttft_steps']:.1f} "
        f"p50 {snap['ttft_steps_p50']:.0f} p99 {snap['ttft_steps_p99']:.0f} "
        f"engine steps, {snap['tokens_per_step']:.2f} tokens/step",
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
    return lines + telemetry_lines(res)


def telemetry_lines(res: ServeResult) -> list[str]:
    """The SLO, goodput and ``measured`` lines, when those are on."""
    lines = []
    if res.slo is not None:
        lines.append(res.slo.describe())
        lines.append(f"goodput: {res.slo.goodput(res.rounds):.2f} SLO-attaining "
                     f"tokens/round over {res.rounds} rounds")
    if res.profiler.enabled:
        lines.append(res.profiler.describe())
        for (kind, bucket, batch), row in sorted(res.profiler.summary().items()):
            lines.append(f"  measured {kind:10s} bucket={bucket} batch={batch}: "
                         f"n={int(row['n'])} {row['seconds']*1e3:.2f}ms "
                         f"mfu={row['measured_mfu']:.4f} "
                         f"mbu={row['measured_mbu']:.4f} "
                         f"bw={row['achieved_gbps']:.1f}GB/s")
    return lines


def write_outputs(args, res: ServeResult) -> list[str]:
    """Write ``--trace`` (validated; an invalid trace raises) and
    ``--metrics-out``; returns the lines saying where."""
    lines = []
    if args.trace:
        path = write_trace(res.tracer, args.trace)
        lines.append(f"trace: {path} (open at ui.perfetto.dev)")
    if args.metrics_out:
        path = write_metrics(registry(args, res), args.metrics_out,
                             extra={"wall_s": res.wall_s, "rounds": float(res.rounds),
                                    "requests": float(len(res.driver.submitted))})
        lines.append(f"metrics: {path}")
    return lines


def main(argv=None):
    args = build_parser().parse_args(argv)
    model, params = load_model(args)
    res = serve(args, model, params)
    for line in report(args, res) + write_outputs(args, res):
        print(line)


if __name__ == "__main__":
    main()
