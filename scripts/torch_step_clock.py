"""Predict a full-width serve run's step clock on the CPU.

  PYTHONPATH=src python scripts/torch_step_clock.py --cache paged \\
      --schedule hybrid --kv-dtype fp8 --host-blocks 512 --blocks 129

The engine's step clock (engine steps, decode steps, chunks, spills,
preemptions, pool stats) depends on prompt lengths, the schedule and the
pool, not on token values or the device.  This script runs the PyTorch
port's engine with the reduced model on the CPU over the workload that
``python -m repro_torch.launch.serve`` builds at full width (the
architecture's vocabulary draws the same prompt lengths; token ids are
folded into the reduced vocabulary), so it prints the clock a full-width
run on the GPU reports, in a fraction of the time.  Flags are the serve
CLI's; the defaults are ``chip_smoke.py``'s serve shape.
"""
from __future__ import annotations

import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Request
from repro_torch.serving.workload import build_workload

DEFAULTS = ["--requests", "64", "--slots", "16", "--max-seq", "1024", "--max-new", "64"]


def main(argv: list[str]) -> None:
    args = serve.build_parser().parse_args(DEFAULTS + argv)
    cfg = reduce_config(args.arch)
    model = build_model(cfg, "cpu")
    params = model.init(args.seed)
    arrivals = build_workload(args.workload, args.requests, vocab=get_config(args.arch).vocab,
                              max_seq=args.max_seq, max_new=args.max_new,
                              seed=args.workload_seed)
    eng = serve.make_engine(args, model, params)
    for i, a in enumerate(arrivals):
        eng.submit(Request(uid=i, prompt=a.prompt % cfg.vocab,
                           max_new_tokens=a.max_new_tokens))
    t0 = time.perf_counter()
    stats = eng.run(100_000)
    print(serve.stats_line(len(arrivals), stats))
    print(f"spills={stats.spills} rehydrations={stats.rehydrations} "
          f"preemptions={stats.preemptions} victim_drains={stats.victim_drains}")
    if args.cache == "paged":
        print(f"pool: {eng.pool.stats}")
    print(f"(CPU, reduced model, {time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main(sys.argv[1:])
