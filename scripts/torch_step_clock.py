"""Predict a full-width serve run's step clock on the CPU.

  PYTHONPATH=src python scripts/torch_step_clock.py --cache paged \\
      --schedule hybrid --kv-dtype fp8 --host-blocks 512 --blocks 129

  PYTHONPATH=src python scripts/torch_step_clock.py --cache paged \\
      --schedule hybrid --blocks 385 --workload rag

  PYTHONPATH=src python scripts/torch_step_clock.py --replicas 2 \\
      --role-map 1p+1d --cache paged --schedule hybrid --blocks 385

The engine's step clock (rounds, engine steps, decode steps, chunks,
spills, preemptions, resubmissions, pool stats; for a cluster also its
routing, migrations and round-clock TTFT) depends on prompt
lengths, arrival rounds, shared prefixes, the schedule and the pool, not
on token values or the device (no request stops at an EOS).  This script
runs ``python -m repro_torch.launch.serve``'s driver and engine with the
reduced model, at the architecture's full vocabulary so the workload's
prompts are the full-width run's, on the CPU, so it prints the clock a
full-width run on the GPU reports, in a fraction of the time.  Flags are
the serve CLI's; the defaults are ``chip_smoke.py``'s serve shape.
"""
from __future__ import annotations

import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.registry import build_model

DEFAULTS = ["--requests", "64", "--slots", "16", "--max-seq", "1024", "--max-new", "64",
            "--device", "cpu"]


def main(argv: list[str]) -> None:
    args = serve.build_parser().parse_args(DEFAULTS + argv)
    model = build_model(reduce_config(args.arch, vocab=get_config(args.arch).vocab), "cpu")
    params = model.init(args.seed)
    t0 = time.perf_counter()
    res = serve.serve(args, model, params)
    print(f"workload: {args.workload} submitted={len(res.driver.submitted)} "
          f"resubmits={res.driver.resubmits} rounds={res.rounds}")
    cl = res.cluster
    if cl is not None:
        cs = res.stats
        print(f"cluster: {cs.summary()}")
        print(f"migrations={cs.migrations} refold_moves={cs.refold_moves} "
              f"ttft_rounds mean {cs.mean_ttft_rounds:.2f} "
              f"p99 {cs.ttft_rounds_percentile(99):.0f} "
              f"prefix_hit_rate={cs.prefix_hit_rate:.4f}")
    for i, eng in enumerate(cl.engines if cl is not None else [res.engine]):
        stats, tag = eng.stats, f"r{i} " if cl is not None else ""
        print(tag + serve.stats_line(len(res.driver.submitted), stats))
        print(f"{tag}spills={stats.spills} rehydrations={stats.rehydrations} "
              f"preemptions={stats.preemptions} victim_drains={stats.victim_drains} "
              f"migrations out/in={stats.migrations_out}/{stats.migrations_in}")
        if args.cache == "paged":
            print(f"{tag}pool: {eng.pool.stats}")
    print(f"(CPU, reduced model, {time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main(sys.argv[1:])
