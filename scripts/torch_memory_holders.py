"""What stays allocated on the card after engines are freed, and who holds it.

    python3 scripts/torch_memory_holders.py [SRC] [--engines N]

Builds reduced llama3.2-1b on the GPU from the port under ``SRC``
(default ``src``) and runs ``N`` short engines one after another, each
through its CUDA graphs (half of them with ``sub_batches=2``), dropping
each engine before the next.  Allocator history is recorded, so every
block still allocated at the end is listed by size with the C++/Python
frame that allocated it.  Prints the memory allocated after every 8
engines and, where ``SRC``'s port has ``serving.programs.release_workspaces``,
the memory after it.  The last line is one JSON object.  Run a parent
tree and this one in turns in one call to compare them.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
from pathlib import Path


def _holders(snapshot: dict, min_bytes: int) -> list[dict]:
    """Allocated blocks of at least ``min_bytes``, grouped by (size, frame):
    the first frame that names a cuBLAS or PyTorch allocation site."""
    groups: collections.Counter = collections.Counter()
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated" or blk["size"] < min_bytes:
                continue
            frames = blk.get("frames", [])
            names = [f.get("name", "") for f in frames]
            site = next((n for n in names if "Blas" in n or "blas" in n or "orkspace" in n),
                        next((f"{f.get('filename', '')}:{f.get('line', '')} {f.get('name', '')}"
                              for f in frames if f.get("filename", "").endswith(".py")),
                             names[0] if names else "?"))
            groups[(blk["size"], site[:160])] += 1
    return [{"bytes": size, "count": n, "site": site}
            for (size, site), n in groups.most_common(12)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?", default="src")
    ap.add_argument("--engines", type=int, default=40)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving import programs
    from repro_torch.serving.engine import Engine, Request

    if not torch.cuda.is_available():
        raise SystemExit("torch_memory_holders: no CUDA device visible")
    dev = torch.device("cuda")
    torch.cuda.memory._record_memory_history(max_entries=100000, context="all", stacks="all")
    model = build_model(reduce_config("llama3.2-1b"), dev)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, model.cfg.vocab, n).astype(np.int32) for n in (5, 9, 3, 12)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    print(f"src {args.src}: {base / 1e6:.1f} MB allocated with the reduced weights")
    trail = []
    for i in range(args.engines):
        eng = Engine(model, params, n_slots=4, max_seq=32, sub_batches=1 + i % 2)
        for j, p in enumerate(prompts):
            eng.submit(Request(uid=j, prompt=p, max_new_tokens=4))
        eng.run()
        del eng
        gc.collect()
        torch.cuda.synchronize()
        if (i + 1) % 8 == 0 or i + 1 == args.engines:
            extra = torch.cuda.memory_allocated(dev) - base
            trail.append((i + 1, extra))
            print(f"  after {i + 1} engines: {extra / 1e6:.1f} MB over the weights")
    holders = _holders(torch.cuda.memory._snapshot(), 1 << 20)
    for h in holders:
        print(f"  held: {h['count']} x {h['bytes']} B  {h['site']}")
    released = None
    if hasattr(programs, "release_workspaces"):
        released = programs.release_workspaces()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(dev) - base
        print(f"  release_workspaces() -> {released}: {after / 1e6:.1f} MB over the weights")
        trail.append(("released", after))
    torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({"src": args.src, "engines": args.engines, "base_bytes": base,
                      "extra_bytes": trail, "holders": holders, "released": released,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
