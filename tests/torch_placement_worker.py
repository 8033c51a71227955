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


def unflat(flat_dict: dict) -> dict:
    """The inverse of :func:`flat`."""
    tree = {}
    for key, a in flat_dict.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _model(task, policy, dtype, weights: str | None = None, **overrides):
    """The reduced llama placed on a ``(data, model)`` mesh of the world
    (``task["model_parallel"]``) under ``policy``, with the config's
    ``overrides``, and this rank's shards of ``params_{weights or
    dtype}.npz``."""
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.placement import Env
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    from repro_torch.models.bridge import shards_from_numpy
    from repro_torch.models.registry import build_model

    mesh = make_host_mesh(task["model_parallel"])
    cfg = reduce_config("llama3.2-1b", vocab=task["vocab"]).with_overrides(dtype=dtype,
                                                                          **overrides)
    model = build_model(cfg, "cpu", Env(axes=mesh_axes(mesh), kv_policy=policy), mesh)
    tree = unflat(dict(np.load(Path(task["out"]) / f"params_{weights or dtype}.npz")))
    return model, shards_from_numpy(tree, model, getattr(torch, dtype))


def train_task(task) -> dict:
    """The placed train step per case (a ``(data, model)`` mesh on the
    world's first ranks, ``Env.fsdp``, the run's accumulation and
    compression) and dtype, from the reference's weights over the task's
    batches (``batches.npz``): each step's loss (also as its bits) and
    grad norm, the whole params after the steps (gathered from the
    shards), the bytes of this rank's ``m`` and ``params`` shards; for the
    FSDP case also the placed prefill's logits (serving gathers the
    weights' d_model split too)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import _gather_whole
    from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.placement import Env
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.bridge import shards_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import make_train_step

    out = {}
    raw = dict(np.load(Path(task["out"]) / "batches.npz"))
    batches = [{k: raw[f"{i}/{k}"] for k in ("inputs", "targets", "mask")}
               for i in range(task["steps"])]
    for case in task["cases"]:
        shape = case["mesh"]
        mesh = DeviceMesh(shape, list(range(shape["data"] * shape["model"])))
        if mesh.coords is None:
            continue
        for dtype in task["dtypes"]:
            cfg = reduce_config("llama3.2-1b", vocab=task["vocab"]).with_overrides(dtype=dtype)
            model = build_model(cfg, "cpu", Env(axes=shape, fsdp=case["fsdp"]), mesh)
            run = RunConfig(model=cfg, parallel=ParallelConfig(
                grad_accum=case["grad_accum"], grad_compression=case["compression"]),
                train=TrainConfig(**task["train"]))
            init_state, train_step, state_specs, _ = make_train_step(model, run)
            state = init_state(0)
            weights = unflat(dict(np.load(Path(task["out"]) / f"params_{dtype}.npz")))
            for p, w in zip(leaves(state["params"]),
                            leaves(shards_from_numpy(weights, model, getattr(torch, dtype))),
                            strict=True):
                p.copy_(w)
            key = f"{case['name']}/{dtype}"
            if case["fsdp"] and dtype == "float32":
                toks = torch.from_numpy(batches[0]["inputs"])
                logits, _ = model.prefill(state["params"], toks, model.init_cache(*toks.shape))
                out[f"{key}/prefill"] = logits.float().numpy()
            losses, norms = [], []
            for b in batches:
                state, metrics = train_step(state, b)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            out[f"{key}/loss"] = np.asarray(losses)
            out[f"{key}/loss_bits"] = np.asarray(losses).view(np.int64)
            out[f"{key}/grad_norm"] = np.asarray(norms)
            out[f"{key}/m_bytes"] = np.asarray(sum(t.numel() * t.element_size()
                                                   for t in leaves(state["opt"]["m"])))
            out[f"{key}/param_bytes"] = np.asarray(sum(t.numel() * t.element_size()
                                                       for t in leaves(state["params"])))
            specs = state_specs()["params"]
            for path, p in flat(state["params"]):
                spec = specs
                for k in path.split("/"):
                    spec = spec[k]
                whole = _gather_whole(model.placement, spec, p)
                if dist.get_rank() == 0:
                    out[f"{key}/params/{path}"] = whole.float().numpy()
    return out


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
    and the EngineStats.  Also the ring gather of sends and receives
    (gloo's route for CUDA tensors) against gloo's own ``all_gather``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.serving.engine import Engine, Request

    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) - 10 * dist.get_rank()
    out = {"by_sum": collectives._ring_gather(x, dist.group.WORLD).float().numpy(),
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


def _fill_pool(model, cache, data: dict, specs: dict) -> None:
    """Write the whole pool leaves of ``data`` (fp8 payloads as bytes) into
    this rank's shards of ``cache`` (``block_tables`` and ``lengths``
    whole)."""
    import torch

    from repro_torch.kernels import ref

    for key, leaf in cache.items():
        whole = torch.from_numpy(data[key])
        if leaf.dtype == torch.float8_e4m3fn:
            whole = whole.view(torch.float8_e4m3fn)
        if key in ("k", "v", "k_scale", "v_scale"):
            whole = model.placement.take(whole, specs[key])
        ref.byte_view(leaf).copy_(ref.byte_view(whole.to(leaf.dtype)))


def paged_model_task(task) -> dict:
    """One placed ``paged_decode_step`` per dtype, pool dtype, block count
    and policy over the pool of ``pool_{dtype}_{kv}_{blocks}.npz`` (the
    test's, with scattered tables and partial blocks): the whole batch's
    logits and the shapes of this rank's pool leaves."""
    import torch

    out = {}
    feed = torch.from_numpy(np.asarray(task["feed"], np.int32))
    for dtype in task["dtypes"]:
        for policy in task["policies"]:
            model, params = _model(task, policy, dtype)
            for kv in task["kv_dtypes"]:
                for nb in task["blocks"]:
                    key = f"{dtype}/{kv}/{nb}/{policy}"
                    data = dict(np.load(Path(task["out"]) / f"pool_{dtype}_{kv}_{nb}.npz"))
                    shape = (feed.shape[0], nb, task["block_size"], task["max_blocks"])
                    cache = model.init_paged_cache(*shape, kv_dtype=kv)
                    _fill_pool(model, cache, data, model.paged_cache_specs(*shape, kv_dtype=kv))
                    logits, _ = model.paged_decode_step(params, cache, feed)
                    out[f"{key}/logits"] = logits.float().numpy()
                    if dtype == "float32":
                        out.update(_block_moves(model, cache, data, key, task["block_size"]))
                    for leaf in ("k", "k_scale", "block_tables"):
                        if leaf in cache:
                            out[f"{key}/shape/{leaf}"] = np.asarray(cache[leaf].shape)
                    out[f"{key}/lengths"] = cache["lengths"].numpy()
    return out


def _block_moves(model, cache, data: dict, key: str, bs: int) -> dict:
    """Row 0's first block copied (copy-on-write) into the last block the
    tables leave free, that block read back into a staging cache
    (positions ``[0, bs)``), written from there into the next free block
    and read back again (``[bs, 2 bs)``): the staging cache's K of this
    rank's heads, and the blocks moved."""
    import torch

    from repro_torch.serving.paged import device as pdev

    free = sorted(set(range(1, cache.n_blocks)) - set(data["block_tables"].ravel().tolist()))
    src, dst, fresh = int(data["block_tables"][0, 0]), free[-1], free[-2]
    staging = model.init_cache(1, 2 * bs, dtype=torch.float32, staging=True)
    pdev.copy_block(cache, src, dst)
    pdev.read_block(staging, cache, dst, 0)
    pdev.write_prompt_block(cache, staging, fresh, 0)
    pdev.read_block(staging, cache, fresh, bs)
    return {f"{key}/staged": staging["k"][:, 0].numpy(), f"{key}/heads": np.asarray(staging.heads),
            f"{key}/moved": np.asarray([src, dst, fresh])}


def paged_engine_task(task) -> dict:
    """The float32 engine over the task's prompts per case (a name, the
    ``model`` axis size, the policies and the Engine's keywords) and mode:
    every request's tokens and step stamps, the EngineStats and the
    PoolStats; then the serve CLI's lines under each ``cli`` flag list.
    Two keywords are the task's, not the Engine's: ``kv_quant`` builds the
    model with the int8 dense cache, ``draft`` (with ``spec_depth``) gives
    the engine the model itself as its draft, placed alike, on the weights
    of ``params_draft.npz``.  ``task["embeds"]`` (``[model axis size,
    policy]`` pairs) also prefills ``embeds.npz``'s frontend embeds and
    tokens and runs one decode step: the whole batch's logits."""
    import contextlib
    import dataclasses
    import io

    import torch
    import torch.distributed as dist

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.distributed import collectives
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine, Request

    # the ring all-reduce (gloo's route for CUDA tensors) against gloo's own
    x = (torch.arange(7, dtype=torch.float32) / 3 + dist.get_rank()).bfloat16()
    out = {"ring_sum": collectives._ring_all_reduce(x, dist.group.WORLD).float().numpy(),
           "gloo_sum": collectives.all_reduce(x.clone(), dist.group.WORLD).float().numpy()}
    for name, mp, policies, kw in task["cases"]:
        kw = dict(kw)
        quant, draft = kw.pop("kv_quant", False), kw.pop("draft", False)
        for policy in policies:
            model, params = _model(dict(task, model_parallel=mp), policy, "float32",
                                   kv_quant=quant)
            if draft:
                kw.update(draft_model=model, draft_params=_model(
                    dict(task, model_parallel=mp), policy, "float32", weights="draft")[1])
            for async_mode in (False, True):
                eng = Engine(model, params, n_slots=task["slots"], max_seq=task["max_seq"],
                             async_mode=async_mode, **kw)
                reqs = [Request(uid=i, prompt=np.asarray(p, np.int32),
                                max_new_tokens=task["max_new"])
                        for i, p in enumerate(task["prompts"])]
                for r in reqs:
                    eng.submit(r)
                stats = eng.run()
                key = f"{name}/{policy}/{'async' if async_mode else 'sync'}"
                for r in reqs:
                    out[f"{key}/tokens{r.uid}"] = np.asarray(r.out_tokens)
                    out[f"{key}/stamps{r.uid}"] = np.asarray(
                        [r.submit_step, r.admit_step, r.first_token_step, r.finish_step])
                out[f"{key}/stats"] = np.asarray(json.dumps(dataclasses.asdict(stats)))
                if kw.get("cache_kind") == "paged":
                    out[f"{key}/pool"] = np.asarray(json.dumps(dataclasses.asdict(
                        eng.pool.stats)))
                    out[f"{key}/kv_bytes"] = np.asarray(eng.kv_bytes())
    for mp, policy in task.get("embeds", []):
        # a frontend's embeds (embeds.npz: (B, F, d_model)) prefilled before
        # the tokens, then one decode step: the whole batch's logits
        model, params = _model(dict(task, model_parallel=mp), policy, "float32")
        data = np.load(Path(task["out"]) / "embeds.npz")
        toks = torch.from_numpy(data["tokens"].astype(np.int64))
        cache = model.init_cache(toks.shape[0], task["max_seq"])
        pre, _ = model.prefill(params, toks, cache, embeds=torch.from_numpy(data["embeds"]))
        dec, _ = model.decode_step(params, cache, torch.from_numpy(data["feed"]))
        out[f"embeds/{mp}/{policy}/prefill"] = pre.float().numpy()
        out[f"embeds/{mp}/{policy}/decode"] = dec.float().numpy()
    serve.reduce_config = lambda arch, **kw: reduce_config(arch, **kw).with_overrides(
        dtype="float32")
    for i, flags in enumerate(task["cli"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--reduced", "--device", "cpu", *flags])
        out[f"cli{i}"] = np.asarray(json.dumps(buf.getvalue().splitlines()))
    return out


def _device_tensors(eng) -> int:
    """The tensors an engine holds: in its attributes and in the dicts,
    lists and objects they hold, three levels down (its caches, weights,
    programs' buffers, token state)."""
    import torch

    def count(v, depth: int) -> int:
        if isinstance(v, torch.Tensor):
            return 1
        if depth == 0:
            return 0
        if isinstance(v, dict):
            items = v.values()
        elif isinstance(v, (list, tuple)):
            items = v
        elif hasattr(v, "__dict__") and not isinstance(v, type):
            items = vars(v).values()
        else:
            return 0
        return sum(count(x, depth - 1) for x in items)

    return count(eng, 3)


def cluster_task(task) -> dict:
    """The port's ``Cluster`` per case over ``replica_meshes(n_replicas,
    model_parallel)`` of this world, each replica's model built on its mesh
    under the case's policy (placed there when the mesh has more than one
    rank; a stand-in on the other ranks) from the float32 weights of
    ``params_float32.npz``, or, when the world cannot be split so, every
    replica on the host mesh's one placed model (a case's ``arch``, when it
    names one, is that reduced model, its weights ``params_{arch}.npz``):
    per mode every request's
    tokens and step stamps, the ``ClusterStats``, ``RouterStats``, each
    replica's ``EngineStats`` and ``PoolStats``, which replicas this rank
    holds, and how many tensors each of the others (the mirrors) holds.
    Then the refusal of a traced cluster, and the serve CLI's lines under
    each ``cli`` flag list."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.placement import Env
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes, replica_meshes, split
    from repro_torch.models.bridge import params_from_numpy, shards_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import Request

    llama = reduce_config("llama3.2-1b", vocab=task["vocab"]).with_overrides(dtype="float32")
    trees = {}

    def built(mesh, policy, arch=None):
        cfg = llama if arch is None else reduce_config(arch).with_overrides(dtype="float32")
        name = "params_float32.npz" if arch is None else f"params_{arch}.npz"
        if name not in trees:
            trees[name] = unflat(dict(np.load(Path(task["out"]) / name)))
        tree = trees[name]
        env = Env(axes=mesh_axes(mesh) if len(mesh.ranks) > 1 else {}, kv_policy=policy)
        model = build_model(cfg, "cpu", env, mesh)
        params = (None if model.mirror else params_from_numpy(tree, "cpu", torch.float32)
                  if model.placement is None else shards_from_numpy(tree, model, torch.float32))
        return model, params

    out = {}
    for case in task["cases"]:
        meshes = replica_meshes(case["replicas"], case["model_parallel"])
        factory, model, params = None, None, None
        if split(meshes):
            def factory(i, meshes=meshes, policy=case["policy"], arch=case.get("arch")):
                return (*built(meshes[i], policy, arch), {})
        else:
            model, params = built(make_host_mesh(case["model_parallel"]), case["policy"],
                                  case.get("arch"))
        for mode in case["modes"]:
            cl = Cluster(model, params, case["replicas"], model_factory=factory,
                         async_mode=mode == "async", **case["cluster"])
            reqs = [Request(uid=i, prompt=np.asarray(p, np.int32),
                            max_new_tokens=case["max_new"])
                    for i, p in enumerate(case["prompts"])]
            for r in reqs:
                cl.submit(r)
            stats = cl.run()
            key = f"{case['name']}/{mode}"
            for r in reqs:
                out[f"{key}/tokens{r.uid}"] = np.asarray(r.out_tokens)
                out[f"{key}/stamps{r.uid}"] = np.asarray(
                    [r.submit_step, r.admit_step, r.first_token_step, r.finish_step])
            out[f"{key}/stats"] = np.asarray(json.dumps(dataclasses.asdict(stats)))
            out[f"{key}/router"] = np.asarray(json.dumps(dataclasses.asdict(cl.router.stats)))
            out[f"{key}/pools"] = np.asarray(json.dumps(
                [dataclasses.asdict(e.pool.stats) if e.cache_kind == "paged" else None
                 for e in cl.engines]))
            out[f"{key}/members"] = np.asarray([e.member for e in cl.engines])
            out[f"{key}/mirror_tensors"] = np.asarray(
                [0 if e.member else _device_tensors(e) for e in cl.engines])
            out[f"{key}/member_tensors"] = np.asarray(
                [_device_tensors(e) if e.member else 0 for e in cl.engines])
    # a tracer on a cluster of more than one rank is refused (ROADMAP 9b.4)
    from repro_torch.serving.telemetry import Tracer
    try:
        Cluster(None, None, 2, tracer=Tracer(wall=False))
    except NotImplementedError as e:
        out["traced"] = np.asarray(str(e))
    serve.reduce_config = lambda arch, **kw: reduce_config(arch, **kw).with_overrides(
        dtype="float32")
    for i, flags in enumerate(task.get("cli", [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--reduced", "--device", "cpu", *flags])
        out[f"cli{i}"] = np.asarray(json.dumps(buf.getvalue().splitlines()))
    return out


def pipeline_task(task) -> dict:
    """``pipeline_forward`` over a ``stage`` mesh of the whole world on the
    reference's toy (``pipe.npz``: stacked ``w`` (L, D, D) and ``x``
    (n_micro, B, S, D); a stage applies ``tanh(h @ w_l)`` for each of its
    layers): the output and the gradient of ``sum(out ** 2)`` with
    respect to this stage's weights; the differentiable reduce-scatter and
    all-gather with their backwards; then ``int8_psum`` of a payload and a
    scale that differ per rank (seeded by the rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.training.pipeline_pp import pipeline_forward, split_stages

    n, rank = dist.get_world_size(), dist.get_rank()
    data = dict(np.load(Path(task["out"]) / "pipe.npz"))
    mesh = DeviceMesh({"stage": n})
    stage = mesh.index(("stage",))
    w = split_stages({"w": torch.from_numpy(data["w"])}, n)["w"][stage:stage + 1]
    w = w.clone().requires_grad_()

    def block_fn(p, h):
        for wl in p["w"]:
            h = torch.tanh(h @ wl)
        return h

    out = pipeline_forward(block_fn, {"w": w}, torch.from_numpy(data["x"]), mesh)
    (g,) = torch.autograd.grad((out ** 2).sum(), [w])
    # a reduce-scatter and its all-gather backward, an all-gather and its
    # reduce-scatter backward (rank r's input: r + 1 times a ramp)
    x = (torch.arange(n * 6, dtype=torch.float64).reshape(n * 2, 3) * (rank + 1)
         ).requires_grad_()
    scattered = collectives.scatter_to(x, dist.group.WORLD, 0)
    (g_scatter,) = torch.autograd.grad((scattered * (rank + 1)).sum(), [x])
    part = x[2 * rank:2 * rank + 2].detach().clone().requires_grad_()
    gathered = collectives.gather_from(part, dist.group.WORLD, 0)
    (g_gather,) = torch.autograd.grad((gathered * (rank + 1)).sum(), [part])
    rng = np.random.default_rng(rank)
    q = torch.from_numpy(rng.integers(-127, 128, task["psum_shape"]).astype(np.int8))
    scale = torch.tensor(float(rng.uniform(0.01, 1.0)), dtype=torch.float32)
    return {"out": out.detach().numpy(), "grad": g.numpy(), "q": q.numpy(),
            "scattered": scattered.detach().numpy(), "g_scatter": g_scatter.numpy(),
            "gathered": gathered.detach().numpy(), "g_gather": g_gather.numpy(),
            "scale": scale.numpy(), "psum": collectives.int8_psum(q, scale, dist.group.WORLD).numpy()}


def train_cli_task(task) -> dict:
    """The train CLI on this world (``--reduced --device cpu``, float32
    weights): its lines and losses under each of ``task["runs"]`` (a name,
    CLI flags and the step checkpoints to keep before it: ``{dir: [steps]}``
    prunes the directory ``dir`` down to those steps, a restart on another
    mesh from a checkpoint of the first)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.launch import train as train_cli

    train_cli.reduce_config = lambda arch: reduce_config(arch).with_overrides(dtype="float32")
    out = {}
    root = Path(task["out"])
    for name, flags, keep in task["runs"]:
        for d, steps in keep.items():
            if int(os.environ["RANK"]) == 0:
                for sub in (root / d).iterdir():
                    if sub.name.startswith("step_") and int(sub.name[5:]) not in steps:
                        shutil.rmtree(sub)
            dist.barrier()
        args = train_cli.build_parser().parse_args(
            ["--reduced", "--device", "cpu"] + [f.replace("{out}", str(root)) for f in flags])
        res = train_cli.run(args, echo=False)
        out[f"{name}/lines"] = np.asarray(json.dumps(res.lines))
        out[f"{name}/losses"] = np.asarray([res.losses[s] for s in sorted(res.losses)])
        out[f"{name}/steps"] = np.asarray(sorted(res.losses))
        out[f"{name}/restarts"] = np.asarray(res.restarts)
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
        out = {"model": model_task, "engine": engine_task, "train": train_task,
               "paged_model": paged_model_task, "paged_engine": paged_engine_task,
               "pipeline": pipeline_task, "train_cli": train_cli_task,
               "cluster": cluster_task}[task["kind"]](task)
        np.savez(Path(task["out"]) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
