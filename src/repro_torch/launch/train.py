"""End-to-end training entry point.

  python -m repro_torch.launch.train --arch llama3.2-1b --batch 8 --seq 1024 --steps 20

  python -m repro_torch.launch.train --arch minicpm-2b --batch 8 --seq 1024 \\
      --steps 4 --schedule wsd --grad-accum 2 --grad-compression int8

  python -m repro_torch.launch.train --arch llama3.2-1b --reduced --device cpu \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-1b \\
      --model-parallel 2 --batch 4 --seq 512 --steps 3

Counterpart of ``repro.launch.train``: config -> model -> train step ->
synthetic data pipeline -> checkpointing -> straggler monitor ->
supervisor (restart from the last checkpoint on a failure;
``--fail-at-step N`` simulates one).  Its flags, defaults and printed
lines (``arch= params= mesh=``, ``step ... loss ... lr ... gnorm ...``,
``restored from step N``, ``done (n restart(s)); checkpoints: [...]``)
are the reference's; its own are ``--seed`` (the random weights),
``--device`` (default cuda; ``cpu`` runs the plain path), ``--layers``
(the arch's width at fewer layers: deepseek keeps its first
``moe_layer_start`` dense layers and the MTP block, so ``--layers 3`` of
deepseek-v3-671b is its three dense layers and no MoE layer) and the
value 0 of ``--ckpt-every`` (no checkpoint: a full-width state of tens
of GB is not written); it also prints tokens/s, ms per step and the
peak device memory.  Every family trains; seamless-m4t-medium's loss
reads ``src_embeds``, which the synthetic batches lack, so it fails
with the reference's KeyError and trains at model level
(``training.trainer.make_train_step``).

Under ``torchrun`` (or any launcher that sets ``WORLD_SIZE`` above 1)
every rank joins the world and the world is a ``(data, model)`` mesh with
``--model-parallel`` ranks on ``model`` (``launch.mesh.make_host_mesh``;
gloo on the CPU or when ranks share a card, NCCL otherwise), and the
model is placed on it (``Env(axes=...)``, as the reference does when its
mesh has more than one device): tensor parallel over ``model``, the rows
over ``data``, the AdamW moments sharded over ``data`` (ZeRO-1).  Every
rank builds the global batch of each step and computes on its rows;
rank 0 prints the lines, checkpoints hold the whole leaves (gathered,
written by rank 0) and a restart restores each rank's shards, on any
mesh.  Without a world it trains on one device, as before.

One difference from the reference: before it restarts, the supervisor
waits for the checkpoint being written, so a failure right after a save
restarts from that save (the reference reads the directory while the
save's thread may still be writing, and can restart from an older step);
on a mesh rank 0 reads the step and every rank restarts from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.placement import Env
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.distributed.collectives import broadcast_object
from repro_torch.distributed.fault_tolerance import StragglerMonitor, Supervisor
from repro_torch.launch.mesh import make_host_mesh, mesh_axes, rank_device, world
from repro_torch.models.registry import build_model
from repro_torch.training.trainer import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "const"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="save every N steps and at the end; 0 saves none (the port's own)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a node failure at this step (tests recovery)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (the width stays the arch's)")
    return ap


@dataclasses.dataclass
class TrainResult:
    state: dict                      # the final train state (on the device; a rank's shards)
    losses: dict[int, float]         # step -> loss of every step run, the last run's
    grad_norms: dict[int, float]     # step -> global grad norm (before clipping)
    step_s: dict[int, float]         # step -> wall seconds (synchronised), the last run's
    restarts: int
    checkpoints: list[int]
    n_params: int
    peak_bytes: int | None           # device peak (CUDA), None on the CPU
    lines: list[str]                 # what was printed (by rank 0)
    mesh: dict[str, int]             # the mesh's axes


def run(args: argparse.Namespace, echo: bool = True) -> TrainResult:
    """Train as ``args`` say and return the final state, per-step losses
    and times.  In a world of more than one rank, every rank calls it."""
    mesh = make_host_mesh(args.model_parallel, device=args.device)
    axes = mesh_axes(mesh)
    rank, n_ranks = world()
    device = str(rank_device(args.device)) if n_ranks > 1 else args.device
    lines: list[str] = []

    def say(line: str) -> None:
        lines.append(line)
        if echo and rank == 0:
            print(line, flush=True)

    cfg = reduce_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_overrides(n_layers=args.layers)
    if n_ranks > 1:
        model = build_model(cfg, device, Env(axes=axes), mesh)
    else:
        model = build_model(cfg, device)
    dev = model.device
    say(f"arch={cfg.name} params={model.n_params():,} mesh={axes}")
    run_cfg = RunConfig(
        model=cfg,
        parallel=ParallelConfig(grad_accum=args.grad_accum,
                                grad_compression=args.grad_compression),
        train=TrainConfig(lr=args.lr, schedule=args.schedule,
                          warmup_steps=max(args.steps // 20, 2), total_steps=args.steps),
    )
    init_state, train_step, state_specs, state_shapes = make_train_step(model, run_cfg)
    placed = None if model.placement is None else (model.placement, state_specs())
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    ck = Checkpointer(args.ckpt_dir, keep_n=3)
    monitor = StragglerMonitor(n_workers=1)
    failed_once = {"done": False}
    out: dict = {"losses": {}, "step_s": {}, "grad_norms": {}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_fn(start_step: int) -> int:
        out.pop("state", None)
        gc.collect()
        if start_step == 0:
            state = init_state(args.seed)
        else:
            _, state = ck.restore(state_shapes(), step=start_step, device=dev, place=placed)
            say(f"restored from step {start_step}")
        for step in range(start_step, args.steps):
            if step == args.fail_at_step and not failed_once["done"]:
                failed_once["done"] = True
                raise RuntimeError("simulated node failure")
            sync()
            t0 = time.perf_counter()
            state, metrics = train_step(state, host_batch(dc, step, 0, 1))
            loss = float(metrics["loss"])
            sync()
            dt = time.perf_counter() - t0
            monitor.record(0, dt)
            out["losses"][step], out["step_s"][step] = loss, dt
            out["grad_norms"][step] = float(metrics["grad_norm"])
            if args.ckpt_every and ((step + 1) % args.ckpt_every == 0
                                    or step + 1 == args.steps):
                ck.save(step + 1, state, blocking=False, place=placed)
            if step % 10 == 0 or step + 1 == args.steps:
                say(f"step {step:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                    f"gnorm {out['grad_norms'][step]:.2f} {dt:.2f}s")
        ck.wait()
        if n_ranks > 1:
            dist.barrier()           # rank 0's last save has landed for every rank
        out["state"] = state
        return args.steps

    def latest_step():
        ck.wait()                    # a save in flight lands before the restart reads
        return broadcast_object(ck.latest_step() if rank == 0 else None)

    sup = Supervisor(run_fn, latest_step, max_restarts=3)
    sup.run(latest_step() or 0)
    say(f"done ({sup.restarts} restart(s)); checkpoints: {ck.all_steps()}")
    tokens = args.batch * args.seq
    steady = [s for st, s in sorted(out["step_s"].items())][1:] or list(out["step_s"].values())
    if steady:
        ms = 1e3 * sum(steady) / len(steady)
        say(f"ms per step {ms:.3f} (mean of {len(steady)} steps after the first; {tokens} "
            f"tokens a step)")
        say(f"tokens/s {tokens / (ms / 1e3):.1f}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    say(f"peak device memory {peak / 1e9:.2f} GB" if peak is not None
        else "peak device memory: not measured (cpu)")
    return TrainResult(state=out.get("state"), losses=out["losses"],
                       grad_norms=out["grad_norms"], step_s=out["step_s"],
                       restarts=sup.restarts, checkpoints=ck.all_steps(),
                       n_params=model.n_params(), peak_bytes=peak,
                       lines=lines, mesh=axes)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
