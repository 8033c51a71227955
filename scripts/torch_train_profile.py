"""Where a train step's device time goes: torch.profiler over steady steps.

  python3 scripts/torch_train_profile.py --arch llama3.2-1b --batch 8 --seq 1024
  python3 scripts/torch_train_profile.py --arch minicpm-2b --batch 8 --seq 1024 \\
      --schedule wsd --grad-accum 2 --grad-compression int8

Takes the train CLI's flags (``repro_torch.launch.train``: the first line
is chip_smoke's train-llama, the second its train-minicpm) plus
``--warmup`` (steps run before the window, default 2) and
``--profile-steps`` (steps in the window, default 2).  It builds the model
and train step as the CLI does, runs the warm-up steps, then profiles the
window's steps, each ending in a synchronize, and prints the card's name
and power limit, then one JSON line: wall ms per step, device busy ms per
step (the union of the device activities: kernels, copies, sets), the idle
share, and the busy time per step split into

- ``gemm``: matrix products (kernel names of cuBLAS / CUTLASS);
- ``flash_fwd``: the flash forward with its lse (both remat launches);
- ``flash_bwd``: the flash backward kernels;
- ``cross_entropy``: kernels launched inside ``cross_entropy_loss`` and
  its backward (autograd nodes whose sequence numbers the forward made);
- ``adamw``: inside ``AdamW.update``;
- ``int8``: inside ``compression.compress_grads`` (with
  ``--grad-compression int8``);
- ``rest``: everything else (norms, activations, embeddings, copies,
  accumulation), with its ten largest kernels by name; device activity
  that no CPU op claimed counts here and is also given alone.

The regions are marked by wrapping those three functions in
``torch.profiler.record_function`` for this script's process only.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import time

import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.training import compression, optimizer
from repro_torch.training.trainer import make_train_step

REGIONS = {"train::cross_entropy": "cross_entropy", "train::adamw": "adamw",
           "train::int8": "int8"}
GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_|sm80_|ampere_", re.I)
ORDER = ["gemm", "flash_fwd", "flash_bwd", "cross_entropy", "adamw", "int8", "rest"]


def _tagged(name, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _region(evt, ce_seqs) -> str | None:
    """The region of a CPU op: the marked range it runs in, or the cross
    entropy's backward (an autograd node the CE forward made)."""
    while evt is not None:
        if evt.name in REGIONS:
            return REGIONS[evt.name]
        if evt.name.startswith("autograd::engine::evaluate_function") and \
                (evt.fwd_thread, evt.sequence_nr) in ce_seqs:
            return "cross_entropy"
        evt = evt.cpu_parent
    return None


def _inside(evt, name) -> bool:
    while evt is not None:
        if evt.name == name:
            return True
        evt = evt.cpu_parent
    return False


def split(events, steps: int) -> dict:
    """Device busy ms per step by category (see the module docstring)."""
    events = list(events)
    ce_seqs = {(e.thread, e.sequence_nr) for e in events
               if e.device_type == DeviceType.CPU and e.sequence_nr >= 0
               and _inside(e, "train::cross_entropy")}
    per = collections.Counter()
    rest = collections.Counter()
    # the marked ranges are mirrored on the device timeline as annotations:
    # not device work
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in REGIONS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                             # the union of the activities
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    attributed = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        region = _region(e, ce_seqs)
        for k in e.kernels:
            if k.name in REGIONS:
                continue
            attributed += k.duration
            if "flash_prefill" in k.name:
                cat = "flash_fwd"
            elif "flash_bwd" in k.name:
                cat = "flash_bwd"
            elif region is not None:
                cat = region
            elif GEMM.search(k.name):
                cat = "gemm"
            else:
                cat = "rest"
                rest[k.name[:90]] += k.duration
            per[cat] += k.duration
    per["rest"] += busy - attributed               # device activity no CPU op claimed
    ms = {c: per[c] / 1e3 / steps for c in ORDER}
    return {"busy_ms": busy / 1e3 / steps, "ms": ms,
            "share": {c: ms[c] * steps * 1e3 / (busy or 1.0) for c in ORDER},
            "unattributed_ms": (busy - attributed) / 1e3 / steps,
            "rest_top": {n: d / 1e3 / steps for n, d in rest.most_common(10)}}


def main(argv=None) -> None:
    ap = train_cli.build_parser()
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    cm.cross_entropy_loss = _tagged("train::cross_entropy", cm.cross_entropy_loss)
    compression.compress_grads = _tagged("train::int8", compression.compress_grads)
    optimizer.AdamW.update = _tagged("train::adamw", optimizer.AdamW.update)

    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_overrides(n_layers=args.layers)
    model = build_model(cfg, args.device or "cuda")
    steps = args.warmup + args.profile_steps
    run = RunConfig(model=cfg,
                    parallel=ParallelConfig(grad_accum=args.grad_accum,
                                            grad_compression=args.grad_compression),
                    train=TrainConfig(lr=args.lr, schedule=args.schedule,
                                      warmup_steps=max(steps // 20, 2), total_steps=steps))
    init_state, train_step, _, _ = make_train_step(model, run)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    state = init_state(args.seed)
    dev = model.device

    def step(i):
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = train_step(state, host_batch(dc, i, 0, 1))
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3, float(metrics["loss"])

    warm = [step(i) for i in range(args.warmup)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window = [step(args.warmup + i) for i in range(args.profile_steps)]
    wall = sum(w for w, _ in window) / len(window)
    res = split(prof.events(), args.profile_steps)
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
                      "seq": args.seq, "grad_accum": args.grad_accum,
                      "grad_compression": args.grad_compression, "card": card,
                      "warmup_ms": [w for w, _ in warm], "wall_ms": wall,
                      "idle_share": 1 - res["busy_ms"] / wall,
                      "losses": [x for _, x in warm + window], **res}))


if __name__ == "__main__":
    main()
