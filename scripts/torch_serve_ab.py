"""Serve throughput of one source tree on the GPU, for A/B comparisons.

  python3 scripts/torch_serve_ab.py [SRC_DIR] [--label NAME] [--reps N] [--graphs on|off]

Imports ``repro_torch`` from SRC_DIR (default: this checkout's ``src``)
and serves ``chip_smoke.py``'s workload (full-width llama3.2-1b, seeded
random weights, 64 requests over 16 slots, max_seq 1024, max_new 64,
async) on the dense decode-only path and the paged hybrid path, each
after a 4-request warm-up, ``--reps`` times.  Prints the card's name and
power limit, then one JSON line with generated tokens/s, wall ms per
engine step, engine steps and launch counts per run.  ``--graphs`` passes
the serve CLI's flag on (a tree from before the flag runs eagerly without
it).  Run it on two trees in turns (A, B, B, A) on one card, back to
back: wall tok/s varies from run to run, and the host's share of a step
depends on what else runs on it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

FLAGS = ["--arch", "llama3.2-1b", "--requests", "64", "--slots", "16", "--max-seq", "1024",
         "--max-new", "64", "--workload", "random", "--workload-seed", "0", "--seed", "0",
         "--device", "cuda", "--async", "on"]
PATHS = {"dense": [], "paged-hybrid": ["--cache", "paged", "--schedule", "hybrid",
                                       "--blocks", "385"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--graphs", choices=("on", "off"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: no CUDA device visible")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    model, params = serve.load_model(serve.build_parser().parse_args(FLAGS))
    graphs = [] if args.graphs is None else ["--graphs", args.graphs]
    runs = {}
    for path, extra in PATHS.items():
        extra = extra + graphs
        serve.serve(serve.build_parser().parse_args(FLAGS + extra + ["--requests", "4"]),
                    model, params)
        runs[path] = []
        for _ in range(args.reps):
            ops.reset_launch_counts()
            res = serve.serve(serve.build_parser().parse_args(FLAGS + extra), model, params)
            runs[path].append({"tok_s": res.stats.generated / res.wall_s,
                               "ms_per_step": res.wall_s * 1e3 / res.stats.engine_steps,
                               "engine_steps": res.stats.engine_steps,
                               "launches": ops.launch_counts()})
    print(json.dumps({"label": args.label or args.src, "card": card, "runs": runs}))


if __name__ == "__main__":
    main()
