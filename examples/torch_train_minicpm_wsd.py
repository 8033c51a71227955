"""Train MiniCPM (MHA, WSD schedule, gradient accumulation, int8 gradient
compression) with checkpoint/restart fault tolerance, on the port — the
loop of ``examples/train_minicpm_wsd.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch_train_minicpm_wsd.py --device cpu
    PYTHONPATH=src python examples/torch_train_minicpm_wsd.py

With ``--device cpu`` it runs the reference example's reduced model and
schedule: 200 steps of batch 16 x 32 tokens, a simulated node failure at
step 120, a checkpoint every 50 steps.  On the card it runs minicpm-2b at
full width and depth (2,725,173,504 parameters, 40 layers, d 2304, vocab
122753) at batch 8 x 1024 tokens for ``--steps`` steps (default 4): no
failure, and a checkpoint only past 50 steps (the full state, params,
AdamW moments and the int8 error feedback, is ~38 GB).
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.distributed.fault_tolerance import Supervisor
from repro_torch.models.registry import build_model
from repro_torch.training.trainer import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' runs reduced")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_minicpm_wsd"))
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cpu = args.device == "cpu"
    steps = args.steps or (200 if cpu else 4)
    crash, every, echo = (120, 50, 25) if cpu else (-1, 50, 1)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = reduce_config("minicpm-2b") if cpu else get_config("minicpm-2b")
    model = build_model(cfg, args.device)
    run = RunConfig(
        model=cfg,
        parallel=ParallelConfig(grad_accum=2, grad_compression="int8"),
        train=TrainConfig(lr=3e-3, schedule="wsd", warmup_steps=10 if cpu else 2,
                          total_steps=steps, stable_frac=0.8),
    )
    init_state, train_step, _, state_shapes = make_train_step(model, run)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32 if cpu else 1024, global_batch=16 if cpu else 8)
    ck = Checkpointer(args.ckpt_dir, keep_n=2)
    crashed = {"done": False}
    out: dict = {"losses": {}, "step_s": {}}

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    def run_fn(start):
        if start == 0:
            state = init_state(0)
        else:
            _, state = ck.restore(state_shapes(), step=start, device=model.device)
            print(f"[recovered from checkpoint @ step {start}]")
        for i in range(start, steps):
            if i == crash and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError(f"simulated node failure @ step {i}")
            sync()
            t0 = time.perf_counter()
            state, m = train_step(state, host_batch(dc, i, 0, 1))
            out["losses"][i] = float(m["loss"])
            sync()
            out["step_s"][i] = time.perf_counter() - t0
            if (i + 1) % every == 0:
                ck.save(i + 1, state)
            if i % echo == 0:
                print(f"step {i:4d} loss {out['losses'][i]:.4f} lr {float(m['lr']):.2e} "
                      f"{out['step_s'][i]:.2f}s")
        out["state"] = state
        return steps

    sup = Supervisor(run_fn, ck.latest_step, max_restarts=2)
    sup.run(0)
    print(f"finished {steps} WSD steps with {sup.restarts} restart(s); "
          f"checkpoints kept: {ck.all_steps()}")
    out.update(restarts=sup.restarts, checkpoints=ck.all_steps(), cfg=cfg)
    return out


if __name__ == "__main__":
    main()
