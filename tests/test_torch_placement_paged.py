"""The paged pool on a mesh: the ``kv_blocks`` placement of the HPU lanes.

(a) ``Model.paged_cache_specs`` against the reference's, leaf for leaf;
(b) each lane's table and length (``ShardedPool.lane_tables``) and the
lse merge of the lanes' partials against the whole pool's attention, in
one process, over the block, position and head cuts of 2 and 4 lanes;
(c) an 8-rank CPU world (gloo, mesh data 4 x model 2): the placed
``paged_decode_step`` against the JAX step on one device over the same
pool (scattered tables, partial last blocks, an idle row), under every
policy, a block count that splits and one that does not, bf16 and fp8
pools, within 5e-2 in bf16 and 1e-4 in float32, each rank's shards at
the specs' shapes;
(d) a 2-rank engine world on data 2 and on model 2: the paged pool on
the hybrid and the decode-only schedules (and the dense cache on the
hybrid one), sync and async, against the JAX engine on one device, the
reduced llama in float32 mode with the JAX weights carried across, on
shared prefixes under enough block pressure to preempt: tokens, step
stamps, ``EngineStats`` and ``PoolStats`` equal on every rank; and the
serve CLI's ``pool:`` line, printed by both ranks, the reference CLI's.
"""
import dataclasses
import json
import math
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
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
from repro_torch.core.offload import Placement, ShardedPool
from repro_torch.core.placement import Env
from repro_torch.kernels import ref
from repro_torch.models.registry import build_model

MESHES = {"2x1": {"data": 2, "model": 1}, "1x2": {"data": 1, "model": 2},
          "4x2": {"data": 4, "model": 2}}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# (a) the specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("blocks", [384, 385])
@pytest.mark.parametrize("mesh", MESHES)
def test_paged_cache_specs_match_reference(mesh, blocks, kv):
    """llama3.2-1b's pool of 16 slots, blocks of 16, 64 a row: every leaf's
    Spec under each policy equals the reference's (385 blocks: the block
    split drops, and the sequence policy cuts the positions in a block)."""
    axes = MESHES[mesh]
    model = build_model(reduce_config("llama3.2-1b").with_overrides(
        n_layers=16, n_kv_heads=8), "meta")
    jmodel = jbuild_model(jreduce_config("llama3.2-1b").with_overrides(
        n_layers=16, n_kv_heads=8), JEnv())
    for policy in POLICIES:
        mine = dataclasses.replace(model, env=Env(axes=axes, kv_policy=policy))
        theirs = dataclasses.replace(jmodel, env=JEnv(axes=axes, kv_policy=policy))
        a = dict(_flat(mine.paged_cache_specs(16, blocks, 16, 64, kv_dtype=kv)))
        b = dict(_flat(theirs.paged_cache_specs(16, blocks, 16, 64, kv_dtype=kv)))
        assert a.keys() == b.keys() and (("k_scale",) in a) == (kv == "fp8")
        for k in a:
            assert tuple(a[k]) == tuple(b[k]), (policy, k, a[k], b[k])
    seq = dataclasses.replace(model, env=Env(axes=axes, kv_policy="sequence"))
    spec = seq.paged_cache_specs(16, blocks, 16, 64)["k"]
    if mesh == "2x1":       # 384 blocks split over data; 385 cut the positions in a block
        assert spec.axes(1 if blocks == 384 else 3) == (("data", "model") if blocks == 384
                                                        else ("data",))


# ---------------------------------------------------------------------------
# (b) the lanes' tables and the merge, in one process
# ---------------------------------------------------------------------------
class LaneMesh:
    """A mesh of named axes seen from one rank (``coords``) with no process
    group: enough for :class:`ShardedPool` and :class:`Placement`'s
    ranges."""

    def __init__(self, shape: dict[str, int], coords: tuple[int, ...]):
        self.axis_names, self.shape, self.coords = tuple(shape), tuple(shape.values()), coords

    def size_of(self, a):
        return self.shape[self.axis_names.index(a)] if a in self.axis_names else 1

    def _live(self, axes):
        return tuple(a for a in self.axis_names if a in axes and self.size_of(a) > 1)

    def size(self, axes):
        return math.prod(self.size_of(a) for a in axes)

    def index(self, axes):
        i = 0
        for a in self._live(axes):
            i = i * self.size_of(a) + self.coords[self.axis_names.index(a)]
        return i


# (mesh, policy, blocks): which cut the lanes make
LANE_CASES = {
    "2-block": ({"data": 2, "model": 1}, "batch", 24),
    "2-position": ({"data": 2, "model": 1}, "sequence", 25),
    "2-head": ({"data": 1, "model": 2}, "head", 25),
    "4-block": ({"data": 4, "model": 1}, "sequence", 24),
    "4-position": ({"data": 2, "model": 2}, "sequence", 25),
    "4-block-position": ({"data": 2, "model": 2}, "sequence", 26),
    "4-block-head": ({"data": 2, "model": 2}, "batch", 24),
}


def _random_pool(rng, n_blocks, bs, hkv, d, lengths, mb):
    """Tables of distinct blocks scattered over the pool (block 0 the null
    block: a row of length 0 keeps it), and K/V of random values."""
    tables = np.zeros((len(lengths), mb), np.int32)
    ids = rng.permutation(np.arange(1, n_blocks))
    at = 0
    for b, n in enumerate(lengths):
        k = -(-n // bs)
        tables[b, :k] = ids[at:at + k]
        at += k
    k = rng.standard_normal((n_blocks, hkv, bs, d)).astype(np.float32)
    v = rng.standard_normal((n_blocks, hkv, bs, d)).astype(np.float32)
    return torch.from_numpy(tables), torch.from_numpy(k), torch.from_numpy(v)


@pytest.mark.parametrize("kv", ["f32", "fp8"])
@pytest.mark.parametrize("case", LANE_CASES)
def test_lane_tables_and_merge_equal_the_whole_pool(case, kv):
    """Every lane attends over its blocks, heads and positions through its
    own table (the block cut compacts a row's held blocks in logical
    order, the position cut shortens every block); the lanes' partials,
    merged by log-sum-exp over the block and position axes and joined
    over the head axes, equal the kernel-level plain version over the
    whole pool.  Lengths 0 and 1, whole blocks and partial last blocks."""
    axes, policy, n_blocks = LANE_CASES[case]
    bs, hkv, g, d, mb = 8, 4, 2, 16, 4
    lengths = [0, 1, 8, 9, 17, 23, 32, 5]
    rng = np.random.default_rng(7)
    tables, k, v = _random_pool(rng, n_blocks, bs, hkv, d, lengths, mb)
    q = torch.from_numpy(rng.standard_normal((len(lengths), hkv * g, d)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    ks = vs = None
    if kv == "fp8":
        k, ks = ref.kv_quantize(k, "fp8")
        v, vs = ref.kv_quantize(v, "fp8")
    want = ref.paged_decode_attention(q, k, v, tables, lens, k_scale=ks, v_scale=vs)
    env = Env(axes=axes, kv_policy=policy)
    spec = env.kv_spec(("kv_blocks", "kv_heads", "kv_seq", "head_dim"), (n_blocks, hkv, bs, d))
    heads = {}
    cut = set()
    for coords in np.ndindex(*axes.values()):
        place = Placement(env, LaneMesh(axes, coords), {})
        parts = [place.part(spec.axes(i), n) for i, n in enumerate((n_blocks, hkv, bs))]
        pool = ShardedPool({}, place=place, n_blocks=n_blocks, n_kv=hkv, block_size=bs,
                           blocks=parts[0], heads=parts[1], pos=parts[2],
                           block_axes=spec.axes(0), head_axes=spec.axes(1),
                           pos_axes=spec.axes(2))
        cut |= {i for i in range(3) if parts[i] != (0, (n_blocks, hkv, bs)[i])}
        t, n = pool.lane_tables(tables, lens)
        sl = [slice(*p) for p in parts]
        shard = [x[sl[0], sl[1], sl[2]].contiguous() for x in (k, v)]
        sc = [None if s is None else s[sl[0], sl[1], sl[2]].contiguous() for s in (ks, vs)]
        (h0, h1) = parts[1]
        o, lse = ref.paged_decode_attention(q[:, h0 * g:h1 * g], *shard, t, n,
                                            k_scale=sc[0], v_scale=sc[1], return_lse=True)
        heads.setdefault(parts[1], []).append((o, lse))
    assert cut, case
    got = torch.cat([ref.lse_merge(heads[h]) for h in sorted(heads)], dim=1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_lane_lengths_by_hand():
    """Two lanes of a block cut (blocks 0-3, 4-7) and of a position cut
    (positions 0-1, 2-3 of blocks of 4), row by row."""
    tables = torch.tensor([[5, 1, 6, 0], [2, 7, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([11, 5, 1], dtype=torch.int32)
    env = Env(axes={"data": 2, "model": 1})
    got = {}
    for lane in (0, 1):
        place = Placement(env, LaneMesh({"data": 2, "model": 1}, (lane, 0)), {})
        blocks = ShardedPool({}, place=place, n_blocks=8, n_kv=1, block_size=4,
                             blocks=(4 * lane, 4 * lane + 4), heads=(0, 1), pos=(0, 4),
                             block_axes=("data",))
        pos = ShardedPool({}, place=place, n_blocks=8, n_kv=1, block_size=4, blocks=(0, 8),
                          heads=(0, 1), pos=(2 * lane, 2 * lane + 2), pos_axes=("data",))
        got[lane] = blocks.lane_tables(tables, lens), pos.lane_tables(tables, lens)
    # block cut: row 0's blocks 5 (full) and 6 (3 of 4) on lane 1, 1 (full) on lane 0
    assert got[0][0][1].tolist() == [4, 4, 1] and got[1][0][1].tolist() == [7, 1, 0]
    assert got[1][0][0][0, :2].tolist() == [1, 2] and got[0][0][0][1, 0].tolist() == 2
    # position cut: full blocks give 2 a lane, the tail its positions past p0
    assert got[0][1][1].tolist() == [6, 3, 1] and got[1][1][1].tolist() == [5, 2, 0]
    assert torch.equal(got[0][1][0], tables)


# ---------------------------------------------------------------------------
# (c) the placed paged decode step on 8 ranks
# ---------------------------------------------------------------------------
B, BS, MB, VOCAB = 4, 16, 8, 256
LENGTHS = [37, 0, 16, 100]
WORLD_BLOCKS = (48, 49)         # 48 splits over 8 lanes, 49 over none
TOL = {"bfloat16": 5e-2, "float32": 1e-4}


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paged8")
    rng = np.random.default_rng(3)
    feed = rng.integers(0, VOCAB, B).astype(np.int32)
    want = {}
    for dtype in TOL:
        cfg = jreduce_config("llama3.2-1b").with_overrides(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=VOCAB,
            head_dim=16, dtype=dtype)
        m = jbuild_model(cfg, JEnv())
        params = m.init(jax.random.key(0))
        np.savez(tmp / f"params_{dtype}.npz",
                 **{k: np.asarray(v, np.float32) for k, v in flat(params)})
        step = jax.jit(m.paged_decode_step)
        for nb in WORLD_BLOCKS:
            # the blocks of each row's next position allocated, an idle row none
            tables, _, _ = _random_pool(rng, nb, BS, 2, 16, [n and n + 1 for n in LENGTHS], MB)
            kv = rng.standard_normal((2, 2, nb, 2, BS, 16)).astype(np.float32)
            for kvd in ("bf16", "fp8"):
                cache = m.init_paged_cache(B, nb, BS, MB, kv_dtype=kvd)
                cache["block_tables"] = jnp.asarray(tables.numpy())
                cache["lengths"] = jnp.asarray(LENGTHS, jnp.int32)
                if kvd == "bf16":
                    for i, key in enumerate(("k", "v")):
                        cache[key] = jnp.asarray(kv[i]).astype(cache[key].dtype)
                else:
                    for i, key in enumerate(("k", "v")):
                        cache[key], cache[f"{key}_scale"] = jref.kv_quantize(
                            jnp.asarray(kv[i]), "fp8")
                data = {k: np.asarray(v) for k, v in cache.items()}
                for key in ("k", "v"):
                    if kvd == "fp8":
                        data[key] = data[key].view(np.uint8)
                    else:
                        data[key] = data[key].astype(np.float32)
                np.savez(tmp / f"pool_{dtype}_{kvd}_{nb}.npz", **data)
                logits, _ = step(params, cache, jnp.asarray(feed))
                want[(dtype, kvd, nb)] = np.asarray(logits, np.float32)
    outs = run_world(8, dict(kind="paged_model", model_parallel=2, vocab=VOCAB,
                             dtypes=list(TOL), policies=list(POLICIES), kv_dtypes=["bf16", "fp8"],
                             blocks=list(WORLD_BLOCKS), block_size=BS, max_blocks=MB,
                             feed=feed.tolist()), tmp)
    return want, outs, tmp


@pytest.mark.parametrize("nb", WORLD_BLOCKS, ids=["splits", "no-split"])
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", list(TOL))
def test_placed_paged_decode_step_matches_reference(world8, dtype, policy, kv, nb):
    want, outs, _ = world8
    key = f"{dtype}/{kv}/{nb}/{policy}"
    got = outs[0][f"{key}/logits"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{key}/logits"], got)
        assert o[f"{key}/lengths"].tolist() == [n + 1 for n in LENGTHS]
    err = float(np.abs(got - want[(dtype, kv, nb)]).max())
    assert err < TOL[dtype], err


@pytest.mark.parametrize("nb", WORLD_BLOCKS, ids=["splits", "no-split"])
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("policy", POLICIES)
def test_block_moves_cross_lanes(world8, policy, kv, nb):
    """Copy-on-write of a block into a block another lane holds, a prefix hit
    reading it back into the staging cache (gathered from the lanes), and
    a finished block handed from the staging cache to its lane and read
    back: each rank's staging heads hold the source block's K exactly (an
    fp8 block dequantized; requantized on the way back in, to one ulp of
    its scale)."""
    _, outs, tmp = world8
    pool = np.load(tmp / f"pool_float32_{kv}_{nb}.npz")
    for o in outs:
        key = f"float32/{kv}/{nb}/{policy}"
        src, dst, fresh = o[f"{key}/moved"].tolist()
        per_lane = {"batch": 12, "sequence": 6, "batch_seq": 6}.get(policy)   # at 48 blocks
        if nb == 48 and per_lane:
            assert src // per_lane != dst // per_lane, (src, dst)
        k = pool["k"][:, src].astype(np.float32)                   # (L, H, bs, D)
        if kv == "fp8":
            k = pool["k"][:, src].view(ml_dtypes.float8_e4m3fn).astype(np.float32) \
                * pool["k_scale"][:, src][..., None]
        h0, h1 = o[f"{key}/heads"].tolist()
        staged = o[f"{key}/staged"]                                # (L, 2 bs, h, D)
        np.testing.assert_array_equal(staged[:, :BS], k.transpose(0, 2, 1, 3)[:, :, h0:h1])
        if kv == "bf16":
            np.testing.assert_array_equal(staged[:, BS:], staged[:, :BS])
        else:
            # requantized: the same payload, and a scale amax * (1 / 448) of
            # 448 * scale, which may round one f32 ulp off the scale
            np.testing.assert_allclose(staged[:, BS:], staged[:, :BS], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("nb", WORLD_BLOCKS, ids=["splits", "no-split"])
def test_each_rank_holds_its_shard_of_the_pool(world8, nb):
    """K and the fp8 scale pool at the shapes the reference's specs give
    rank r (coords (r // 2, r % 2) on data 4 x model 2); the tables whole."""
    _, outs, _ = world8
    jm = jbuild_model(jreduce_config("llama3.2-1b").with_overrides(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=VOCAB,
        head_dim=16), JEnv())
    full = {"k": (2, nb, 2, BS, 16), "k_scale": (2, nb, 2, BS)}
    for policy in POLICIES:
        specs = dataclasses.replace(jm, env=JEnv(axes=MESHES["4x2"], kv_policy=policy)
                                    ).paged_cache_specs(B, nb, BS, MB, kv_dtype="fp8")
        for r, o in enumerate(outs):
            mesh = LaneMesh(MESHES["4x2"], (r // 2, r % 2))
            for leaf, shape in full.items():
                spec = tuple(specs[leaf]) + (None,) * len(shape)
                want = []
                for d, n in enumerate(shape):
                    ax = spec[d] if isinstance(spec[d], tuple) else (
                        () if spec[d] is None else (spec[d],))
                    want.append(n // mesh.size(ax))
                assert o[f"float32/fp8/{nb}/{policy}/shape/{leaf}"].tolist() == want, \
                    (policy, r, leaf)
            assert o[f"float32/fp8/{nb}/{policy}/shape/block_tables"].tolist() == [B, MB]


# ---------------------------------------------------------------------------
# (d) the engine on 2 ranks
# ---------------------------------------------------------------------------
SLOTS, MAX_SEQ, MAX_NEW = 2, 32, 12
SHARED = list(range(2, 13))
PROMPTS = [SHARED, SHARED, list(range(1, 10)), list(range(3, 8)), list(range(2, 9))]
PAGED = dict(cache_kind="paged", block_size=4)
HYBRID = dict(schedule="hybrid", prefill_chunk=8)
# name -> (Engine keywords, policies); 10 blocks split over 2 lanes, 9 do not
# (the sequence policy then cuts the positions in a block)
ENGINE_CASES = {
    "paged-10": (dict(PAGED, n_blocks=10), list(POLICIES)),
    "hybrid-10": (dict(PAGED, n_blocks=10, **HYBRID), list(POLICIES)),
    "paged-9": (dict(PAGED, n_blocks=9), ["sequence"]),
    "hybrid-9": (dict(PAGED, n_blocks=9, **HYBRID), ["sequence"]),
    "dense-hybrid": (HYBRID, ["batch", "sequence"]),
}
MODES = ("sync", "async")
CLI = ["--requests", "5", "--slots", "3", "--max-new", "6", "--max-seq", "32",
       "--workload-seed", "1", "--cache", "paged", "--block-size", "4", "--blocks", "14",
       "--schedule", "hybrid", "--prefill-chunk", "8"]
CLI_FP8 = CLI + ["--kv-dtype", "fp8"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paged2")
    cfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    m = jbuild_model(cfg, JEnv())
    params = m.init(jax.random.key(0))
    np.savez(tmp / "params_float32.npz",
             **{k: np.asarray(v, np.float32) for k, v in flat(params)})
    push = jdev.sync_slot
    # the reference's sync_slot may alias the manager's row (see
    # tests/test_torch_hybrid.py); it is handed a copy, what its code means
    jdev.sync_slot = lambda cache, slot, row, length=None: push(
        cache, slot, np.array(row, np.int32), length)
    want = {}
    try:
        for name, (kw, _) in ENGINE_CASES.items():
            for mode in MODES:
                eng = JEngine(m, params, n_slots=SLOTS, max_seq=MAX_SEQ,
                              async_mode=mode == "async", **kw)
                reqs = [JRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                        for i, p in enumerate(PROMPTS)]
                for r in reqs:
                    eng.submit(r)
                stats = dataclasses.asdict(eng.run())
                pool = dataclasses.asdict(eng.pool.stats) if "cache_kind" in kw else None
                want[(name, mode)] = (reqs, stats, pool,
                                      eng.kv_bytes() if "cache_kind" in kw else None)
        cli = {}
        for flags in (CLI, CLI_FP8):
            jserve_reduce = jserve.reduce_config
            jserve.reduce_config = lambda arch: jreduce_config(arch).with_overrides(
                dtype="float32")
            argv = sys.argv
            sys.argv = ["repro.launch.serve", "--reduced", *flags]
            try:
                import contextlib
                import io
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    jserve.main()
            finally:
                sys.argv = argv
                jserve.reduce_config = jserve_reduce
            cli[tuple(flags)] = buf.getvalue().splitlines()
    finally:
        jdev.sync_slot = push
    cases = [[f"{name}-{mp}", mp, policies, kw] for name, (kw, policies) in ENGINE_CASES.items()
             for mp in (1, 2)]
    outs = run_world(2, dict(kind="paged_engine", cases=cases, vocab=cfg.vocab, slots=SLOTS,
                             max_seq=MAX_SEQ, max_new=MAX_NEW, prompts=PROMPTS,
                             cli=[CLI, CLI_FP8]), tmp)
    return want, cli, outs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [(name, policy) for name, (_, pols) in ENGINE_CASES.items()
                                  for policy in pols], ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("mp", [1, 2], ids=["data2", "model2"])
def test_placed_paged_engine_matches_reference(world2, mp, case, mode):
    want, _, outs = world2
    name, policy = case
    reqs, stats, pool, kv_bytes = want[(name, mode)]
    key = f"{name}-{mp}/{policy}/{mode}"
    for o in outs:
        for r in reqs:
            assert o[f"{key}/tokens{r.uid}"].tolist() == r.out_tokens, r.uid
            assert o[f"{key}/stamps{r.uid}"].tolist() == [
                r.submit_step, r.admit_step, r.first_token_step, r.finish_step]
        assert json.loads(str(o[f"{key}/stats"])) == stats
        if pool is not None:
            assert json.loads(str(o[f"{key}/pool"])) == pool
            assert int(o[f"{key}/kv_bytes"]) == kv_bytes
    if name == "paged-10":
        assert stats["preemptions"] >= 1 and pool["hash_hits"] >= 1 and pool["cow_copies"] >= 1


@pytest.mark.parametrize("flags", [CLI, CLI_FP8], ids=["bf16", "fp8"])
def test_placed_serve_cli_prints_the_pool_line_on_every_rank(world2, flags):
    """``python -m repro_torch.launch.serve --cache paged --schedule
    hybrid`` on two ranks (data 2, the balancer's policy): rank 0 prints
    the reference CLI's ``requests=``, ``latency:`` and ``pool:`` lines, and
    rank 1 the same ``pool:`` line alone."""
    _, cli, outs = world2
    theirs = cli[tuple(flags)]
    i = [CLI, CLI_FP8].index(flags)
    ranks = [json.loads(str(o[f"cli{i}"])) for o in outs]
    pool = next(line for line in theirs if line.startswith("pool:"))
    assert ranks[1] == [pool]
    for prefix in ("requests=", "latency:", "pool:"):
        assert next(line for line in ranks[0] if line.startswith(prefix)) == \
            next(line for line in theirs if line.startswith(prefix))


def test_ring_all_reduce_equals_gloo_all_reduce(world2):
    """The all-reduce of CUDA tensors over gloo, a ring gather of sends and
    a sum in rank order, gives what gloo's all-reduce gives, bit for bit
    (bf16, two ranks), the same on every rank."""
    _, _, outs = world2
    for o in outs:
        np.testing.assert_array_equal(o["ring_sum"], o["gloo_sum"])
        np.testing.assert_array_equal(o["ring_sum"], outs[0]["ring_sum"])
