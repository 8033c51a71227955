"""The host KV tier across the HPU lanes.

(a) ``Model.paged_cache_specs`` with the host tier and ``cache_specs`` of
the int8 ``kv_quant`` dense cache against the reference's, leaf for leaf,
under the five policies on three meshes, and each rank's host-tier shard
at the shape its spec gives;
(b) in one process, every rank's hot window (its lane of the device pool
through :meth:`ShardedPool.lane_tables` from the cold length on) and cold
window (its share of the host tier through
:meth:`ShardedPool.host_lane_tables`), each with its lse, merged as the
placed step merges them (a window's copy on a rank of the axes it is not
split on dropped), against the reference's tiered attention (the hot and
the cold window of the kernel-level oracle, lse-merged) over block,
position and head cuts of 2 and 4 lanes, bf16, fp8 and int8 pools, no,
some and all full blocks cold;
(c) a 2-rank world (gloo) on data 2 and on model 2: tiered engines (fp8
and int8 pools with a host tier on a pool too small for both sequences:
spills, re-hydrations, no preemption) on both schedules, sync and async,
against the JAX engine in float32 with its weights carried across:
tokens, step stamps, ``EngineStats`` and ``PoolStats`` equal on every
rank; and the serve CLI under ``--host-blocks``: rank 0 prints the
reference CLI's ``requests=``, ``latency:``, ``pool:`` and ``kv tier:``
lines, rank 1 the same ``pool:`` and ``kv tier:`` lines.

The reference engine runs with its ``sync_slot`` / ``sync_host_slot``
race removed (it is handed copies of the rows, as in
``tests/test_torch_tiering.py``).
"""
import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_placement_paged import MESHES, LaneMesh, _flat
from torch_placement_worker import flat, run_world

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import POLICIES
from repro.core.placement import Env as JEnv
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.offload import Placement
from repro_torch.core.placement import Env
from repro_torch.kernels import ref
from repro_torch.models import dense
from repro_torch.models.registry import build_model


# ---------------------------------------------------------------------------
# (a) the specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_host_tier_and_kv_quant_specs_match_reference(mesh, kv):
    """llama3.2-1b's pool of 16 slots, blocks of 16, 385 device and 512
    host blocks: every leaf's Spec under each policy equals the
    reference's (the host leaves' block axis never split); the int8 dense
    cache's payload and scales too; and each rank's host-tier shard of
    :func:`dense.init_paged_cache` has the shape its spec gives."""
    axes = MESHES[mesh]
    cfg = reduce_config("llama3.2-1b").with_overrides(n_layers=2, n_kv_heads=8)
    jcfg = jreduce_config("llama3.2-1b").with_overrides(n_layers=2, n_kv_heads=8)
    model = build_model(cfg.with_overrides(kv_quant=True), "meta")
    jmodel = jbuild_model(jcfg.with_overrides(kv_quant=True), JEnv())
    for policy in POLICIES:
        mine = dataclasses.replace(model, env=Env(axes=axes, kv_policy=policy))
        theirs = dataclasses.replace(jmodel, env=JEnv(axes=axes, kv_policy=policy))
        for a, b in ((mine.paged_cache_specs(16, 385, 16, 64, kv_dtype=kv, host_blocks=512),
                      theirs.paged_cache_specs(16, 385, 16, 64, kv_dtype=kv, host_blocks=512)),
                     (mine.cache_specs(16, 1024), theirs.cache_specs(16, 1024))):
            a, b = dict(_flat(a)), dict(_flat(b))
            assert a.keys() == b.keys()
            for k in a:
                assert tuple(a[k]) == tuple(b[k]), (policy, k, a[k], b[k])
        specs = mine.paged_cache_specs(16, 385, 16, 64, kv_dtype=kv, host_blocks=512)
        env = Env(axes=axes, kv_policy=policy)
        for coords in np.ndindex(*axes.values()):
            place = Placement(env, LaneMesh(axes, coords), {})
            pool = dense.init_paged_cache(cfg, 16, 385, 16, 64, kv_dtype=kv, host_blocks=512,
                                          device="meta", place=place)
            dh = cfg.resolved_head_dim()
            for leaf, full in (("host_k", (2, 513, 8, 16, dh)), ("host_k_scale", (2, 513, 8, 16))):
                if leaf in pool:
                    assert tuple(pool[leaf].shape) == place.local_shape(specs[leaf], full)
            assert pool["host_k"].shape[1] == 513 and pool["host_tables"].shape == (16, 64)
            assert pool.host_pos == place.part(specs["host_k"].axes(3), 16)


# ---------------------------------------------------------------------------
# (b) the hot and cold windows of every rank, merged
# ---------------------------------------------------------------------------
# (mesh, policy, device blocks): the device pool's cut and the host tier's
TIER_LANES = {
    "2-block": ({"data": 2, "model": 1}, "batch", 24),             # host whole
    "2-block-hostpos": ({"data": 2, "model": 1}, "sequence", 24),  # host positions cut
    "2-position": ({"data": 2, "model": 1}, "sequence", 25),       # both positions cut
    "2-head": ({"data": 1, "model": 2}, "head", 25),               # both heads cut
    "4-block-head": ({"data": 2, "model": 2}, "batch", 24),
    "4-block-position": ({"data": 2, "model": 2}, "batch_seq", 26),
    "4-position": ({"data": 2, "model": 2}, "sequence", 25),
}
BS, HKV, G, D, MB, N_HOST = 8, 4, 2, 16, 4, 12
LENGTHS = [0, 1, 8, 9, 17, 23, 32, 5]


def _tiered_inputs(rng, n_blocks, kv, cold):
    """Tables whose cold columns name the null block (as a spill leaves
    them) and host tables naming distinct host blocks there; pools of
    random K/V, quantized for fp8/int8."""
    full = [max(n - 1, 0) // BS for n in LENGTHS]          # full blocks below the append one
    n_cold = [{"none": 0, "some": f // 2, "all": f}[cold] for f in full]
    tables = np.zeros((len(LENGTHS), MB), np.int32)
    host_tables = np.zeros((len(LENGTHS), MB), np.int32)
    dev_ids = iter(rng.permutation(np.arange(1, n_blocks)))
    host_ids = iter(rng.permutation(np.arange(1, N_HOST)))
    for b, n in enumerate(LENGTHS):
        for j in range(-(-n // BS)):
            if j < n_cold[b]:
                host_tables[b, j] = next(host_ids)
            else:
                tables[b, j] = next(dev_ids)
    pools = {}
    for name, n in (("", n_blocks), ("host_", N_HOST)):
        for key in ("k", "v"):
            x = torch.from_numpy(rng.standard_normal((n, HKV, BS, D)).astype(np.float32))
            if kv == "bf16":
                pools[f"{name}{key}"], pools[f"{name}{key}_scale"] = x.bfloat16(), None
            else:
                pools[f"{name}{key}"], pools[f"{name}{key}_scale"] = ref.kv_quantize(x, kv)
    q = torch.from_numpy(rng.standard_normal((len(LENGTHS), HKV * G, D)).astype(np.float32))
    return (q, torch.from_numpy(tables), torch.from_numpy(host_tables),
            torch.tensor(LENGTHS, dtype=torch.int32),
            torch.tensor([c * BS for c in n_cold], dtype=torch.int32), pools)


def _jax(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("cold", ["none", "some", "all"])
@pytest.mark.parametrize("kv", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("case", TIER_LANES)
def test_hot_and_cold_windows_of_the_lanes_merge_to_the_reference(case, kv, cold):
    axes, policy, n_blocks = TIER_LANES[case]
    rng = np.random.default_rng(11)
    q, tables, host_tables, lens, cold_lens, pools = _tiered_inputs(rng, n_blocks, kv, cold)
    jq = _jax(q)
    hot = jref.paged_decode_attention(
        jq, _jax(pools["k"]), _jax(pools["v"]), _jax(tables), _jax(lens),
        starts=_jax(cold_lens), return_lse=True, k_scale=_jax(pools["k_scale"]),
        v_scale=_jax(pools["v_scale"]))
    far = jref.paged_decode_attention(
        jq, _jax(pools["host_k"]), _jax(pools["host_v"]), _jax(host_tables), _jax(cold_lens),
        return_lse=True, k_scale=_jax(pools["host_k_scale"]),
        v_scale=_jax(pools["host_v_scale"]))
    want = torch.from_numpy(np.array(jref.lse_merge([hot, far]), np.float32))
    env = Env(axes=axes, kv_policy=policy)
    shape = (n_blocks, HKV, BS, D)
    spec = env.kv_spec(("kv_blocks", "kv_heads", "kv_seq", "head_dim"), shape)
    hspec = env.kv_spec((None, "kv_heads", "kv_seq", "head_dim"), (N_HOST, HKV, BS, D))
    by_heads, cut = {}, set()
    for coords in np.ndindex(*axes.values()):
        place = Placement(env, LaneMesh(axes, coords), {})
        parts = [place.part(spec.axes(i), n) for i, n in enumerate(shape[:3])]
        hpos = place.part(hspec.axes(2), BS)
        assert place.part(hspec.axes(1), HKV) == parts[1]
        pool = dense.ShardedPool(
            {"host_k": pools["host_k"]}, place=place, n_blocks=n_blocks, n_kv=HKV,
            block_size=BS, blocks=parts[0], heads=parts[1], pos=parts[2],
            block_axes=spec.axes(0), head_axes=spec.axes(1), pos_axes=spec.axes(2),
            host_pos=hpos, host_pos_axes=hspec.axes(2))
        cut |= {i for i in range(3) if parts[i] != (0, shape[i])} | ({3} if hpos != (0, BS)
                                                                      else set())
        (h0, h1), qs = parts[1], q[:, parts[1][0] * G:parts[1][1] * G]
        windows = []
        for name, sl, (t, n), axes_of in (
                ("", [slice(*parts[0]), slice(h0, h1), slice(*parts[2])],
                 pool.lane_tables(tables, lens, cold_lens), pool.merge_axes),
                ("host_", [slice(None), slice(h0, h1), slice(*hpos)],
                 pool.host_lane_tables(host_tables, cold_lens), pool.host_merge_axes)):
            shard = [pools[f"{name}{k}"][tuple(sl)].contiguous() for k in ("k", "v")]
            sc = [None if pools[f"{name}{k}_scale"] is None
                  else pools[f"{name}{k}_scale"][tuple(sl)].contiguous()
                  for k in ("k", "v")]
            o, lse = ref.paged_decode_attention(qs, *shard, t, n, k_scale=sc[0],
                                                v_scale=sc[1], return_lse=True)
            windows.append((o, lse, axes_of))
        # the placed step's merge: a window's copy on a rank whose index over
        # the merged axes the window does not split is not 0 is dropped
        union = tuple(a for a in axes if any(a in w[2] for w in windows))
        for o, lse, axes_of in windows:
            rest = tuple(a for a in union if a not in axes_of)
            if place.mesh.index(rest) == 0:
                by_heads.setdefault(parts[1], []).append((o, lse))
    assert cut, case
    got = torch.cat([ref.lse_merge(by_heads[h]) for h in sorted(by_heads)], dim=1)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_lane_tables_drop_the_cold_blocks():
    """A row whose first two blocks are cold (their columns name the null
    block): two lanes of a block cut (blocks 0-3, 4-7) count only the hot
    blocks, whatever lane holds the null block; a position cut too."""
    tables = torch.tensor([[0, 0, 5, 2], [0, 6, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([15, 7], dtype=torch.int32)
    cold = torch.tensor([8, 4], dtype=torch.int32)
    env = Env(axes={"data": 2, "model": 1})
    got = {}
    for lane in (0, 1):
        place = Placement(env, LaneMesh({"data": 2, "model": 1}, (lane, 0)), {})
        blocks = dense.ShardedPool({}, place=place, n_blocks=8, n_kv=1, block_size=4,
                                   blocks=(4 * lane, 4 * lane + 4), heads=(0, 1), pos=(0, 4),
                                   block_axes=("data",))
        pos = dense.ShardedPool({}, place=place, n_blocks=8, n_kv=1, block_size=4,
                                blocks=(0, 8), heads=(0, 1), pos=(2 * lane, 2 * lane + 2),
                                pos_axes=("data",))
        got[lane] = blocks.lane_tables(tables, lens, cold), pos.lane_tables(tables, lens, cold)
    # block cut: row 0's hot blocks 5 (full) on lane 1 and 2 (3 of 4) on lane 0
    assert got[0][0][1].tolist() == [3, 0] and got[1][0][1].tolist() == [4, 3]
    assert got[0][0][0][0, 0] == 2 and got[1][0][0][0, 0] == 1 and got[1][0][0][1, 0] == 2
    # position cut: the hot blocks of each row, 2 positions a lane, the tail past p0
    assert got[0][1][1].tolist() == [4, 2] and got[1][1][1].tolist() == [3, 1]
    assert got[0][1][0][0, :2].tolist() == [5, 2]


# ---------------------------------------------------------------------------
# (c) tiered engines and the CLI on 2 ranks
# ---------------------------------------------------------------------------
SLOTS, MAX_SEQ, MAX_NEW = 2, 32, 10
SPILL = [list(range(1, 10)), list(range(3, 8))]
PROMPTS = SPILL + [SPILL[0]]          # the first prompt again: its freed prefix re-hydrates
TIGHT = dict(cache_kind="paged", block_size=4, n_blocks=10, host_blocks=8)
HYBRID = dict(schedule="hybrid", prefill_chunk=8)
# name -> (Engine keywords, {model axis size: policies}); 10 blocks split over
# 2 lanes (batch: the blocks over data, the host tier whole; sequence: the
# blocks over the lanes, the host tier's positions too; head: the heads of
# both), 9 do not (the sequence policy then cuts the positions of both)
TIERED = {
    "fp8": (dict(TIGHT, kv_dtype="fp8"), {1: ["batch", "sequence"], 2: ["sequence", "head"]}),
    "fp8-hybrid": (dict(TIGHT, kv_dtype="fp8", **HYBRID),
                   {1: ["batch"], 2: ["sequence", "head"]}),
    "int8-hybrid": (dict(TIGHT, kv_dtype="int8", **HYBRID),
                    {1: ["batch"], 2: ["sequence", "head"]}),
    "fp8-9": (dict(TIGHT, kv_dtype="fp8", n_blocks=9), {1: ["sequence"], 2: ["sequence"]}),
}
MODES = ("sync", "async")
CLI = ["--requests", "5", "--slots", "3", "--max-new", "6", "--max-seq", "32",
       "--workload-seed", "1", "--cache", "paged", "--block-size", "4", "--blocks", "12",
       "--schedule", "hybrid", "--prefill-chunk", "8", "--kv-dtype", "fp8",
       "--host-blocks", "16"]


@contextlib.contextmanager
def copied_rows():
    """The reference's ``sync_slot`` / ``sync_host_slot`` handed copies of
    the manager's rows (their ``jnp.asarray`` may alias a row the manager
    rewrites)."""
    push, push_host = jdev.sync_slot, jdev.sync_host_slot
    jdev.sync_slot = lambda cache, slot, row, length=None: push(
        cache, slot, np.array(row, np.int32), length)
    jdev.sync_host_slot = lambda cache, slot, row, cold_len: push_host(
        cache, slot, np.array(row, np.int32), cold_len)
    try:
        yield
    finally:
        jdev.sync_slot, jdev.sync_host_slot = push, push_host


def jax_engine(m, params, kw, mode, prompts=PROMPTS, n_slots=SLOTS, max_seq=MAX_SEQ,
               max_new=MAX_NEW):
    """The reference engine's run: (requests, EngineStats, PoolStats or None)."""
    eng = JEngine(m, params, n_slots=n_slots, max_seq=max_seq, async_mode=mode == "async",
                  **kw)
    reqs = [JRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = dataclasses.asdict(eng.run())
    pool = dataclasses.asdict(eng.pool.stats) if kw.get("cache_kind") == "paged" else None
    return reqs, stats, pool


def jax_cli(flags):
    """The reference CLI's lines in float32 mode (the draft's config too)."""
    saved, argv = jserve.reduce_config, sys.argv
    jserve.reduce_config = lambda arch, **kw: jreduce_config(arch, **kw).with_overrides(
        dtype="float32")
    sys.argv = ["repro.launch.serve", "--reduced", *flags]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv, jserve.reduce_config = argv, saved
    return buf.getvalue().splitlines()


def assert_engine(outs, key, want):
    """Every rank's tokens, step stamps, EngineStats and PoolStats equal the
    reference engine's."""
    reqs, stats, pool = want
    for o in outs:
        for r in reqs:
            assert o[f"{key}/tokens{r.uid}"].tolist() == r.out_tokens, (key, r.uid)
            assert o[f"{key}/stamps{r.uid}"].tolist() == [
                r.submit_step, r.admit_step, r.first_token_step, r.finish_step], (key, r.uid)
        assert json.loads(str(o[f"{key}/stats"])) == stats, key
        if pool is not None:
            assert json.loads(str(o[f"{key}/pool"])) == pool, key


def assert_cli(outs, theirs, i, prefixes, rank_prefixes):
    """Rank 0's lines of ``prefixes`` equal the reference CLI's; every
    other rank prints exactly its lines of ``rank_prefixes``."""
    ranks = [json.loads(str(o[f"cli{i}"])) for o in outs]
    for prefix in prefixes:
        assert next(line for line in ranks[0] if line.startswith(prefix)) == \
            next(line for line in theirs if line.startswith(prefix)), prefix
    for lines in ranks[1:]:
        assert lines == [line for line in theirs if line.startswith(rank_prefixes)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiered2")
    cfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    m = jbuild_model(cfg, JEnv())
    params = m.init(jax.random.key(0))
    np.savez(tmp / "params_float32.npz",
             **{k: np.asarray(v, np.float32) for k, v in flat(params)})
    with copied_rows():
        want = {(name, mode): jax_engine(m, params, kw, mode)
                for name, (kw, _) in TIERED.items() for mode in MODES}
        cli = jax_cli(CLI)
    cases = [[f"{name}-{mp}", mp, policies, kw] for name, (kw, by_mp) in TIERED.items()
             for mp, policies in by_mp.items()]
    outs = run_world(2, dict(kind="paged_engine", cases=cases, vocab=cfg.vocab, slots=SLOTS,
                             max_seq=MAX_SEQ, max_new=MAX_NEW, prompts=PROMPTS, cli=[CLI]),
                     tmp)
    return want, cli, outs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [(name, mp, policy) for name, (_, by_mp) in TIERED.items()
                                  for mp, pols in by_mp.items() for policy in pols],
                         ids=lambda c: f"{c[0]}-{'data2' if c[1] == 1 else 'model2'}-{c[2]}")
def test_placed_tiered_engine_matches_reference(world, case, mode):
    """Spills and re-hydrations of the host tier on two ranks, the step
    clock and pool of the reference's one device."""
    want, _, outs = world
    name, mp, policy = case
    assert_engine(outs, f"{name}-{mp}/{policy}/{mode}", want[(name, mode)])
    _, stats, pool = want[(name, mode)]
    assert stats["spills"] >= 1 and stats["rehydrations"] >= 1 and stats["preemptions"] == 0
    assert pool["peak_in_use"] > TIGHT["n_blocks"] // 2       # blocks on both lanes


def test_placed_serve_cli_with_host_tier_prints_reference_lines(world):
    """``--host-blocks`` under a 2-rank world (data 2, the balancer's
    batch policy): rank 0's ``requests=``, ``latency:``, ``pool:`` and ``kv
    tier:`` lines are the reference CLI's, and rank 1 prints the same
    ``pool:`` and ``kv tier:`` lines."""
    _, cli, outs = world
    assert any(line.startswith("kv tier: spills=") and "spills=0" not in line for line in cli)
    assert_cli(outs, cli, 0, ("requests=", "latency:", "pool:", "kv tier:"),
               ("pool:", "kv tier:"))
