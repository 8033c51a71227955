"""Replicas and disaggregated roles on per-replica meshes.

A cluster under a ``torch.distributed`` world (gloo ranks of
``tests/torch_placement_worker.py``) gives each replica its own slice of
the world (``launch.mesh.replica_meshes``): every rank runs the whole
cluster loop, each replica's engine a mirror on the ranks outside its
mesh, and a migrating request's KV moves between meshes.  Against the JAX
``Cluster`` in float32 with its weights carried across as numpy:

(a) a 2-rank world, one rank a replica: ``round_robin`` and
``prefix_affinity`` on rag-like shared prompts, ``1p+1d`` on the paged
pool (bf16; fp8 with a host tier that spills) and on the dense cache,
the dense llama's and deepseek's (its cache's leaves are MLA latents, not
K/V), sync and async;
(b) a 4-rank world, two replicas of data 2 and of model 2: ``1p+1d`` on
the fp8 pool with a host tier and on the dense cache, async;
(c) a 2-rank world with three replicas: the meshes cannot be split, so
every replica is the host mesh's one placed model;
each with tokens and step stamps per request, ``ClusterStats``,
``RouterStats``, every replica's ``EngineStats`` (inside the cluster
stats) and ``PoolStats`` equal to the reference's on every rank, and no
tensor held by a replica's engine on a rank outside its mesh;
(d) in one process, over the ``LaneMesh`` helper: the whole blocks that
``copy_blocks_out`` gathers from a ``ShardedPool`` (every lane's
``blocks_piece``) and what ``copy_blocks_in`` writes into one (bf16, fp8,
int8 with scale tiles), and a ``ShardedCache``'s slot through
``export_slot`` / ``insert`` under the batch, head and sequence policies
(also the int8 ``kv_quant`` cache), byte-equal to the unplaced cache's;
(e) the serve CLI under a 2-rank world with ``--replicas 2 --role-map
1p+1d``: rank 0's ``cluster:``, ``requests=``, ``disagg:``, ``latency:``
and ``pool[r{i}]:`` lines equal the reference CLI's, rank 1 prints its
replica's ``pool[r1]:`` line; a traced cluster on more than one rank is
refused.

The reference's paged async engine runs with copied table rows (its
``sync_slot`` race, ROADMAP §3).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_placement_paged import LaneMesh
from test_torch_placement_tiered import copied_rows, jax_cli
from torch_placement_worker import flat, run_world

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env as JEnv
from repro.models.registry import build_model as jbuild_model
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Request as JRequest
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.offload import Placement
from repro_torch.core.placement import Env
from repro_torch.models import dense
from repro_torch.serving import kv_cache
from repro_torch.serving.paged import device as pdev

DOC_A, DOC_B = list(range(20, 32)), list(range(40, 52))
PROMPTS = {
    "disagg": [list(range(1, 6)), list(range(7, 10)), list(range(2, 13)), list(range(2, 13)),
               list(range(4, 25))],
    "rag": [DOC_A + [60, 61, 62], DOC_B + [63, 64], DOC_A + [65, 66], DOC_B + [67, 68, 69],
            DOC_A + [70]],
    "spill": [list(range(1, 10)), list(range(3, 8)), list(range(1, 10))],
}
BASE = dict(n_slots=2, max_seq=32)
PAGED = dict(BASE, cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=4)
TIER = dict(BASE, cache_kind="paged", block_size=4, n_blocks=10, host_blocks=8,
            kv_dtype="fp8", schedule="hybrid", prefill_chunk=8)
DENSE = dict(BASE, cache_kind="dense")


def _case(name, replicas, mp, policy, cluster, prompts, modes, max_new=6, arch=None):
    return dict(name=name, replicas=replicas, model_parallel=mp, policy=policy, cluster=cluster,
                prompts=PROMPTS[prompts], modes=list(modes), max_new=max_new, arch=arch)


# a family whose dense cache holds other leaves than K/V (MLA's latents)
FAMILY = "deepseek-v3-671b"


BOTH = ("sync", "async")
# (a) and (c): the 2-rank world
WORLD2 = [
    _case("round-robin", 2, 1, "batch", dict(PAGED, route="round_robin"), "rag", BOTH),
    _case("prefix-affinity", 2, 1, "batch", dict(PAGED, route="prefix_affinity"), "rag", BOTH),
    _case("disagg-paged", 2, 1, "batch", dict(PAGED, roles="1p+1d"), "disagg", BOTH),
    _case("disagg-fp8-tier", 2, 1, "batch", dict(TIER, roles="1p+1d"), "spill", BOTH,
          max_new=10),
    _case("disagg-dense", 2, 1, "batch", dict(DENSE, roles="1p+1d"), "disagg", BOTH),
    _case("disagg-deepseek", 2, 1, "batch", dict(DENSE, roles="1p+1d"), "disagg", BOTH,
          arch=FAMILY),
    _case("shared-3", 3, 1, "batch", dict(PAGED, n_blocks=18, roles="1p+1d+1m"), "disagg",
          ("async",)),
]
# (b): the 4-rank world, two replicas of two ranks each
WORLD4 = [
    _case("disagg-fp8-tier-data2", 2, 1, "batch", dict(TIER, roles="1p+1d"), "spill",
          ("async",), max_new=10),
    _case("disagg-dense-data2", 2, 1, "batch", dict(DENSE, roles="1p+1d"), "disagg",
          ("async",)),
    _case("disagg-fp8-tier-model2", 2, 2, "sequence", dict(TIER, roles="1p+1d"), "spill",
          ("async",), max_new=10),
    _case("disagg-dense-model2", 2, 2, "head", dict(DENSE, roles="1p+1d"), "disagg",
          ("async",)),
]
CLI = ["--replicas", "2", "--role-map", "1p+1d", "--cache", "paged", "--schedule", "hybrid"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference models in float32 and their weights, also as the npz
    files the ranks load: the dense llama's, the one ``arch=None`` names,
    and :data:`FAMILY`'s."""
    tmp = tmp_path_factory.mktemp("cluster-weights")
    models = {}
    for arch, name in ((None, "params_float32.npz"), (FAMILY, f"params_{FAMILY}.npz")):
        cfg = jreduce_config(arch or "llama3.2-1b").with_overrides(dtype="float32")
        m = jbuild_model(cfg, JEnv())
        params = m.init(jax.random.key(0))
        np.savez(tmp / name, **{k: np.asarray(v, np.float32) for k, v in flat(params)})
        models[arch] = (m, params)
    return models, jreduce_config("llama3.2-1b").with_overrides(dtype="float32"), tmp


def _world(n, cases, weights, tmp_path_factory, cli=()):
    _, cfg, wtmp = weights
    tmp = tmp_path_factory.mktemp(f"cluster{n}")
    for npz in wtmp.glob("params_*.npz"):
        (tmp / npz.name).symlink_to(npz)
    return run_world(n, dict(kind="cluster", cases=cases, vocab=cfg.vocab, cli=list(cli)), tmp)


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    return _world(2, WORLD2, weights, tmp_path_factory, cli=[CLI])


@pytest.fixture(scope="module")
def world4(weights, tmp_path_factory):
    return _world(4, WORLD4, weights, tmp_path_factory)


_REFERENCE = {}


def reference(weights, case, mode):
    """The JAX cluster's run of ``case`` in ``mode``: (requests, ClusterStats,
    RouterStats, each replica's PoolStats or None)."""
    key = (json.dumps(case["cluster"], sort_keys=True), case["replicas"],
           json.dumps(case["prompts"]), case["max_new"], mode, case["arch"])
    if key not in _REFERENCE:
        m, params = weights[0][case["arch"]]
        with copied_rows():
            cl = JCluster(m, params, case["replicas"], async_mode=mode == "async",
                          **case["cluster"])
            reqs = [JRequest(uid=i, prompt=np.asarray(p, np.int32),
                             max_new_tokens=case["max_new"])
                    for i, p in enumerate(case["prompts"])]
            for r in reqs:
                cl.submit(r)
            stats = cl.run()
        _REFERENCE[key] = (reqs, dataclasses.asdict(stats), dataclasses.asdict(cl.router.stats),
                           [dataclasses.asdict(e.pool.stats) if e.cache_kind == "paged" else None
                            for e in cl.engines])
    return _REFERENCE[key]


def assert_cluster(outs, case, mode, weights):
    """Every rank's run of ``case`` equals the reference's; each replica's
    engine holds tensors on its mesh's ranks and none elsewhere."""
    reqs, stats, router, pools = reference(weights, case, mode)
    key = f"{case['name']}/{mode}"
    for rank, o in enumerate(outs):
        for r in reqs:
            assert o[f"{key}/tokens{r.uid}"].tolist() == r.out_tokens, (key, rank, r.uid)
            assert o[f"{key}/stamps{r.uid}"].tolist() == [
                r.submit_step, r.admit_step, r.first_token_step, r.finish_step], (key, r.uid)
        assert json.loads(str(o[f"{key}/stats"])) == stats, (key, rank)
        assert json.loads(str(o[f"{key}/router"])) == router, (key, rank)
        assert json.loads(str(o[f"{key}/pools"])) == pools, (key, rank)
        members = o[f"{key}/members"]
        assert not o[f"{key}/mirror_tensors"].any(), (key, rank)
        assert all(n > 0 for n, held in zip(o[f"{key}/member_tensors"], members) if held)
    return stats


def _ids(cases):
    return [f"{c['name']}-{mode}" for c in cases for mode in c["modes"]]


@pytest.mark.parametrize("case,mode", [(c, mode) for c in WORLD2[:-1] for mode in c["modes"]],
                         ids=_ids(WORLD2[:-1]))
def test_replica_per_rank_matches_reference(world2, weights, case, mode):
    """(a) Two ranks, each one replica: every rank's cluster is the
    reference's; each rank holds one replica and mirrors the other."""
    stats = assert_cluster(world2, case, mode, weights)
    for rank, o in enumerate(world2):
        assert o[f"{case['name']}/{mode}/members"].tolist() == [rank == 0, rank == 1]
    if "roles" in case["cluster"]:
        assert stats["migrations"] > 0
    if case["cluster"].get("host_blocks"):
        assert sum(r["engine"]["spills"] for r in stats["replicas"]) > 0
    if case["cluster"].get("route") == "prefix_affinity":
        assert stats["prefix_hit_tokens"] > 0


def test_replicas_share_the_mesh_when_the_world_cannot_split(world2, weights):
    """(c) Three replicas on two ranks: every replica is the host mesh's
    placed model, every rank a member of every one."""
    case = WORLD2[-1]
    stats = assert_cluster(world2, case, "async", weights)
    assert stats["migrations"] > 0
    for o in world2:
        assert o["shared-3/async/members"].all()


@pytest.mark.parametrize("case", WORLD4, ids=[c["name"] for c in WORLD4])
def test_placed_replicas_match_reference(world4, weights, case):
    """(b) Four ranks, two replicas of two ranks each (data 2 or model 2):
    placed replicas, KV migrating between the meshes."""
    stats = assert_cluster(world4, case, "async", weights)
    assert stats["migrations"] > 0
    for rank, o in enumerate(world4):
        assert o[f"{case['name']}/async/members"].tolist() == [rank < 2, rank >= 2]


def test_serve_cli_cluster_lines_under_a_world(world2):
    """(e) ``--replicas 2 --role-map 1p+1d`` under two ranks: rank 0's
    cluster lines are the reference CLI's; rank 1 prints its replica's
    pool line.  A tracer on a cluster of two ranks is refused."""
    with copied_rows():
        theirs = jax_cli(CLI)
    ranks = [json.loads(str(o["cli0"])) for o in world2]
    for prefix in ("cluster:", "requests=", "disagg:", "latency:", "pool[r0]:", "pool[r1]:"):
        want = [line for line in theirs if line.startswith(prefix)]
        assert want and [line for line in ranks[0] if line.startswith(prefix)] == want, prefix
    assert ranks[1] == [line for line in theirs if line.startswith("pool[r1]:")]
    for o in world2:        # telemetry across ranks waits for ROADMAP item 9b.4
        assert "9b.4" in str(o["traced"])


# ---------------------------------------------------------------------------
# (d) the whole blocks and slots of a placed cache, in one process
# ---------------------------------------------------------------------------
# (mesh, policy, blocks): a block cut, a position cut, a head cut, and two
POOL_CASES = {
    "2-block": ({"data": 2, "model": 1}, "batch", 24),
    "2-position": ({"data": 2, "model": 1}, "sequence", 25),
    "2-head": ({"data": 1, "model": 2}, "head", 25),
    "4-block-head": ({"data": 2, "model": 2}, "batch", 24),
    "4-block-position": ({"data": 2, "model": 2}, "batch_seq", 26),
}
POOL_CFG = reduce_config("llama3.2-1b").with_overrides(n_layers=2, n_kv_heads=4)
BS, MB = 4, 6
OUT, IN = [3, 17, 5, 22, 9], [20, 1, 14, 7, 11]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _random_fill(rng, leaves: dict) -> None:
    for key, t in leaves.items():
        if key in ("block_tables", "lengths", "host_tables", "cold_lengths"):
            continue
        x = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
        if t.dtype == torch.int8:
            t.copy_((x * 40).round().clamp(-127, 127))
        else:
            t.copy_(x.to(t.dtype))


def _lanes(axes, policy, build):
    """``build(place, spec_of)`` on every rank of a ``LaneMesh``: each rank's
    cache, in row-major rank order."""
    env = Env(axes=axes, kv_policy=policy)
    return [build(Placement(env, LaneMesh(axes, coords), {}), env)
            for coords in np.ndindex(*axes.values())]


@pytest.mark.parametrize("kv", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_placed_pool_blocks_out_and_in_are_the_unplaced_bytes(case, kv):
    axes, policy, n_blocks = POOL_CASES[case]
    shape = (4, n_blocks, BS, MB)
    whole = dense.init_paged_cache(POOL_CFG, *shape, kv_dtype=kv)
    _random_fill(np.random.default_rng(5), whole)
    defs = dense.paged_cache_defs(POOL_CFG, *shape, kv_dtype=kv)

    def shard(place, env, src=whole):
        pool = dense.init_paged_cache(POOL_CFG, *shape, kv_dtype=kv, place=place)
        for key in pdev._pool_keys(pool):
            part = place.take(src[key], env.kv_spec(defs[key].logical, defs[key].shape))
            _bytes(pool[key]).copy_(_bytes(part))
        return pool

    lanes = _lanes(axes, policy, shard)
    assert any(p.blocks != (0, n_blocks) or p.heads != (0, 4) or p.pos != (0, BS)
               for p in lanes), case
    keys = pdev._pool_keys(whole)
    dtypes = [whole[k].dtype for k in keys]

    def assembled(pools, ids):
        return pdev.blocks_assemble([pdev.blocks_piece(p, ids) for p in pools], ids, keys,
                                    dtypes, 4, BS)

    got, want = assembled(lanes, OUT), pdev.copy_blocks_out(whole, OUT)
    assert list(got) == list(want)
    for key in keys:
        assert got[key].dtype == want[key].dtype
        assert torch.equal(_bytes(got[key]), _bytes(want[key])), key
    # land the whole payload's columns 1.. into other blocks of empty pools
    empty = dense.init_paged_cache(POOL_CFG, *shape, kv_dtype=kv)
    sel, dst = [1, 2, 3, 4], IN[:4]
    pdev.copy_blocks_in(empty, want, sel, dst)
    targets = _lanes(axes, policy, lambda place, env: shard(place, env, src=empty))
    blank = _lanes(axes, policy, lambda place, env: dense.init_paged_cache(
        POOL_CFG, *shape, kv_dtype=kv, place=place))
    for pool in blank:
        pdev.copy_blocks_in(pool, got, sel, dst)
    landed, target = assembled(blank, IN), assembled(targets, IN)
    for key in keys:
        assert torch.equal(_bytes(landed[key]), _bytes(target[key])), key


CACHE_CASES = {
    "batch-data2": ({"data": 2, "model": 1}, "batch"),
    "batch-data2-model2": ({"data": 2, "model": 2}, "batch"),
    "head-model2": ({"data": 1, "model": 2}, "head"),
    "sequence-data2": ({"data": 2, "model": 1}, "sequence"),
    "sequence-model2": ({"data": 1, "model": 2}, "sequence"),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "kv_quant"])
@pytest.mark.parametrize("case", CACHE_CASES)
def test_placed_cache_slot_export_and_insert_are_the_unplaced_bytes(case, quant):
    axes, policy = CACHE_CASES[case]
    cfg = POOL_CFG.with_overrides(kv_quant=quant)
    B, S = 4, 16
    whole = dense.init_cache(cfg, B, S)
    _random_fill(np.random.default_rng(7), whole)
    whole["lengths"].copy_(torch.tensor([3, 16, 9, 1], dtype=torch.int32))
    defs = dense.cache_defs(cfg, B, S)

    def shard(place, env, src=whole):
        cache = dense.init_cache(cfg, B, S, place=place)
        for key, leaf in cache.items():
            leaf.copy_(place.take(src[key], env.kv_spec(defs[key].logical, defs[key].shape)))
        return cache

    lanes = _lanes(axes, policy, shard)
    assert any(c.rows != (0, B) or c.seq != (0, S) or c.heads != (0, 4) for c in lanes), case
    keys = list(whole)
    for slot in range(B):
        got = kv_cache.slot_assemble([kv_cache.slot_piece(c, slot) for c in lanes], keys, S, 4)
        want = kv_cache.export_slot(whole, slot)
        for key in keys:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(_bytes(got[key]), _bytes(want[key])), (slot, key)
        # insert the slot into another slot of empty caches, and gather it back
        empty = dense.init_cache(cfg, B, S)
        dst = (slot + 1) % B
        kv_cache.insert(empty, want, dst)
        blank = _lanes(axes, policy, lambda place, env: dense.init_cache(cfg, B, S,
                                                                         place=place))
        for cache in blank:
            kv_cache.insert(cache, got, dst)
        back = kv_cache.slot_assemble([kv_cache.slot_piece(c, dst) for c in blank], keys, S, 4)
        for key in keys:
            assert torch.equal(_bytes(back[key]), _bytes(kv_cache.export_slot(empty, dst)[key]))


class _OtherRanks:
    """The mesh of a replica held by another rank: this one is outside it."""
    ranks, coords, host = [1], None, None


@pytest.mark.parametrize("kw", [DENSE, PAGED, TIER, dict(DENSE, sub_batches=2),
                                dict(PAGED, spec_depth=2, prefill_chunk=8)],
                         ids=["dense", "paged-hybrid", "fp8-tier", "sub-batches", "spec"])
def test_a_mirror_engine_holds_no_tensor(kw):
    """(d) A replica's engine on a rank outside its mesh, built on the
    model's stand-in: no weights, no cache, no staging or draft cache, no
    token state, no generator on the device; the same engine on the mesh
    holds them."""
    from torch_placement_worker import _device_tensors

    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import Engine

    cfg = reduce_config("llama3.2-1b")
    stand_in = build_model(cfg, "cpu", Env(), _OtherRanks())
    assert stand_in.mirror and stand_in.init(0) is None
    spec = dict(draft_model=stand_in, draft_params=None) if kw.get("spec_depth") else {}
    mirror = Engine(stand_in, None, **kw, **spec)
    assert not mirror.member and not mirror.graphs and _device_tensors(mirror) == 0
    model = build_model(cfg, "cpu")
    spec = dict(draft_model=model, draft_params=model.init(1)) if kw.get("spec_depth") else {}
    member = Engine(model, model.init(0), **kw, **spec)
    assert member.member and _device_tensors(member) > 0
