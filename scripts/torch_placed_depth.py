"""How a placed model's decode step drifts from one rank's with depth.

  torchrun --nproc-per-node 2 scripts/torch_placed_depth.py [--layers 1 2 4 8 16]
      [--policy head] [--dtype float32] [--device cpu]

Two ranks on a (data 1, model 2) mesh (gloo when they share a card).
For each depth, llama3.2-1b at full width with seeded random weights (seed
0) cut to that many layers: the first 16 prompts of the serve workload
prefilled one per slot, then one teacher-forced decode step (each row
fed its prompt's last token; ``chip_smoke.teacher_forced``), in the
chosen dtype with a cache of the same dtype, through the tensor-parallel
model under ``--policy`` and through the one-rank model; and, as the
yardstick, the one-rank model against itself decoding the prompts as two
batches of 8 rows (other GEMM shapes, so other rounding); and the one-rank
model rounding its row-parallel products as two ranks do
(``chip_smoke.tp_rounding``: wo and w_down as two half-K products, each
rounded to the dtype, then summed), against the one-rank model and
against the placed one.  Rank 0 prints the card's name and power limit,
then one JSON line per depth: the max logit, every max |logit| difference
and its argmax agreement.  The random weights amplify any rounding
difference with depth.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.placement import Env  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, mesh_axes, rank_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.workload import build_workload  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    ap.add_argument("--policy", default="head")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None, help="torch device (default: this rank's card)")
    args = ap.parse_args()
    dev = rank_device(args.device)
    mesh = make_host_mesh(2, device=dev)
    rank0 = dist.get_rank() == 0
    if rank0 and dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    base = get_config("llama3.2-1b")
    prompts = [a.prompt for a in build_workload("random", 16, vocab=base.vocab, max_seq=1024,
                                                max_new=64, seed=0)]
    for n in args.layers:
        cfg = base.with_overrides(n_layers=n, dtype=args.dtype)
        one_model = build_model(cfg, dev)
        params = one_model.init(0)
        one = cs.teacher_forced(one_model, params, prompts)
        eight = torch.cat([cs.teacher_forced(one_model, params, prompts[:8]),
                           cs.teacher_forced(one_model, params, prompts[8:])])
        with cs.tp_rounding(cfg):
            rounded = cs.teacher_forced(one_model, params, prompts)
        del one_model, params
        placed = build_model(cfg, dev, Env(axes=mesh_axes(mesh), kv_policy=args.policy), mesh)
        two = cs.teacher_forced(placed, placed.init(0), prompts)
        if rank0:
            print(json.dumps({
                "layers": n, "dtype": args.dtype, "policy": args.policy,
                "max_logit": float(one.abs().max()),
                "placed_err": float((two - one).abs().max()),
                "placed_argmax_equal": int((two.argmax(-1) == one.argmax(-1)).sum()),
                "eight_row_err": float((eight - one).abs().max()),
                "eight_row_argmax_equal": int((eight.argmax(-1) == one.argmax(-1)).sum()),
                "tp_rounding_err": float((rounded - one).abs().max()),
                "tp_rounding_argmax_equal": int((rounded.argmax(-1) == one.argmax(-1)).sum()),
                "placed_vs_tp_rounding": float((two - rounded).abs().max()),
                "placed_vs_tp_rounding_argmax_equal":
                    int((two.argmax(-1) == rounded.argmax(-1)).sum())}),
                flush=True)
        del placed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
