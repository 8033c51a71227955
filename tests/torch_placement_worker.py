"""One rank of a CPU ``torch.distributed`` world for the placement tests.

``run_world(n, task, tmp_path)`` starts ``n`` processes of this file,
joined over gloo through a ``FileStore`` under ``tmp_path`` (no TCP
port: the suite runs under several workers at once), and waits for them
with its own timeout: a hung rendezvous fails the test, kills the ranks
and never holds the suite.  Each rank runs ``task`` (a JSON dict, see
:func:`main`) and writes ``rank{r}.npz``; the caller reads them.  This
file imports no JAX.
"""
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 240         # seconds for a whole world: start, work, exit


def run_world(n: int, task: dict, tmp_path: Path, timeout: float = WORLD_TIMEOUT) -> list:
    """Run ``task`` on an ``n``-rank gloo world; returns each rank's npz
    contents (a dict of arrays), rank by rank."""
    task = dict(task, store=str(tmp_path / "store"), out=str(tmp_path))
    (tmp_path / "task.json").write_text(json.dumps(task))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, __file__, str(tmp_path / "task.json")],
                                          env=dict(env, RANK=str(r)), stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a {n}-rank world did not finish in {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r].read_text()[-3000:]) for r, p in enumerate(procs)
           if p.returncode]
    assert not bad, bad
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def flat(tree, prefix: str = ""):
    """``(path/to/leaf, leaf)`` pairs of a nested dict: how the weights
    travel to the ranks in an npz."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _model(task, policy, dtype):
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.placement import Env
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    from repro_torch.models.bridge import shards_from_numpy
    from repro_torch.models.registry import build_model

    mesh = make_host_mesh(task["model_parallel"])
    cfg = reduce_config("llama3.2-1b", vocab=task["vocab"]).with_overrides(dtype=dtype)
    model = build_model(cfg, "cpu", Env(axes=mesh_axes(mesh), kv_policy=policy), mesh)
    weights = dict(np.load(Path(task["out"]) / f"params_{dtype}.npz"))
    tree = {}
    for key, a in weights.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return model, shards_from_numpy(tree, model, getattr(torch, dtype))


def model_task(task) -> dict:
    """Prefill a (B, Sq) batch into a fresh cache, then one teacher-forced
    decode step, per policy and dtype: the whole batch's logits."""
    import torch

    out = {}
    toks = torch.from_numpy(np.asarray(task["tokens"], np.int64))
    feed = torch.from_numpy(np.asarray(task["feed"], np.int32))
    for dtype in task["dtypes"]:
        for policy in task["policies"]:
            model, params = _model(task, policy, dtype)
            cache = model.init_cache(toks.shape[0], task["max_seq"])
            pre, _ = model.prefill(params, toks, cache)
            dec, _ = model.decode_step(params, cache, feed)
            out[f"{dtype}/{policy}/prefill"] = pre.float().numpy()
            out[f"{dtype}/{policy}/decode"] = dec.float().numpy()
            out[f"{dtype}/{policy}/kv_bytes"] = np.asarray(
                sum(v.numel() * v.element_size() for v in cache.values()))
    return out


def engine_task(task) -> dict:
    """The float32 engine over the task's prompts, per mesh (its ``model``
    axis size), policy and mode: every request's tokens and step stamps,
    and the EngineStats.  Also a gather built from ``all_reduce`` (gloo's
    route for CUDA tensors) against gloo's own ``all_gather``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.serving.engine import Engine, Request

    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) - 10 * dist.get_rank()
    out = {"by_sum": collectives._stack_by_sum(x, dist.group.WORLD).float().numpy(),
           "native": collectives.gather_stack(x, dist.group.WORLD).float().numpy()}
    for mp in task["model_parallel"]:
        for policy in task["policies"]:
            model, params = _model(dict(task, model_parallel=mp), policy, "float32")
            for async_mode in (False, True):
                eng = Engine(model, params, n_slots=task["slots"], max_seq=task["max_seq"],
                             async_mode=async_mode)
                reqs = [Request(uid=i, prompt=np.asarray(p, np.int32),
                                max_new_tokens=task["max_new"])
                        for i, p in enumerate(task["prompts"])]
                for r in reqs:
                    eng.submit(r)
                stats = eng.run()
                key = f"{mp}/{policy}/{'async' if async_mode else 'sync'}"
                for r in reqs:
                    out[f"{key}/tokens{r.uid}"] = np.asarray(r.out_tokens)
                    out[f"{key}/stamps{r.uid}"] = np.asarray(
                        [r.submit_step, r.admit_step, r.first_token_step, r.finish_step])
                out[f"{key}/stats"] = np.asarray(json.dumps(dataclasses.asdict(stats)))
    return out


def main(path: str) -> None:
    import torch
    import torch.distributed as dist

    task = json.loads(Path(path).read_text())
    torch.set_num_threads(1)
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", store=dist.FileStore(task["store"], n), rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT))
    try:
        out = {"model": model_task, "engine": engine_task}[task["kind"]](task)
        np.savez(Path(task["out"]) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
