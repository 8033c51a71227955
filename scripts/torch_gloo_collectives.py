"""Time the collectives' routes between ranks that share a card over gloo.

  torchrun --nproc-per-node 2 scripts/torch_gloo_collectives.py [--mb 8 1236]
      [--device cpu] [--repeat 3]

gloo carries ``all_reduce`` on CUDA tensors (through host memory) but not
``all_gather``, ``reduce_scatter`` or send / receive, so
``repro_torch.distributed.collectives`` builds those as rings of sends
and receives through pinned host memory (``shift``, ``_ring_gather``,
``_ring_reduce_scatter``).  Beside them this times what they replaced:
a gather as an ``all_reduce`` of a zeroed stack and a reduce-scatter as
an ``all_reduce`` and a slice.  For each size (MB of bf16 per rank) rank 0
prints one JSON line: the best of ``--repeat`` wall times in ms of each
route, synchronised on the device, and how far the routes' results
are apart (the reduce-scatters sum in other orders).  Rank 0
first prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch.mesh import init_world, rank_device  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, nargs="+", default=[8, 1236])
    ap.add_argument("--device", default=None, help="torch device (default: this rank's card)")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    dev = rank_device(args.device)
    init_world(dev)
    group, n, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    if rank == 0 and dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)

    def timed(fn):
        best, out = float("inf"), None
        for _ in range(args.repeat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best, out

    for mb in args.mb:
        numel = int(mb * 2 ** 20 / 2) // n * n
        gen = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(numel, generator=gen, device=dev).to(torch.bfloat16)
        row = {"mb_per_rank": mb, "ranks": n, "device": str(dev), "backend": dist.get_backend()}
        row["all_reduce_ms"], _ = timed(lambda: dist.all_reduce(x.clone(), group=group))
        row["reduce_scatter_by_all_reduce_ms"], a = timed(lambda: _rs_by_all_reduce(x, group))
        row["reduce_scatter_ring_ms"], b = timed(
            lambda: collectives._ring_reduce_scatter(x, group, 0))
        part = x[:numel // n].contiguous()
        row["gather_by_sum_ms"], c = timed(lambda: _gather_by_all_reduce(part, group))
        row["gather_ring_ms"], d = timed(lambda: collectives._ring_gather(part, group))
        row["shift_ms"], _ = timed(lambda: collectives.shift(part, group, 1))
        # bf16 sums in another order: a few units of bf16's last place
        row["reduce_scatter_max_diff"] = float((a.float() - b.float()).abs().max())
        row["gather_equal"] = bool(torch.equal(c, d))
        if rank == 0:
            print(json.dumps(row), flush=True)
        del x, a, b, c, d
    dist.destroy_process_group()


def _gather_by_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` in its slot of a zeroed stack, summed."""
    buf = x.new_zeros((dist.get_world_size(group), *x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return buf


def _rs_by_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    total = x.clone()
    dist.all_reduce(total, group=group)
    return total.narrow(0, r * x.shape[0] // n, x.shape[0] // n).contiguous()


if __name__ == "__main__":
    main()
