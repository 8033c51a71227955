"""The port's paged KV cache against the JAX package: the paged attention
oracle and plain version (against ``ref.paged_decode_attention`` and the
interpret-mode Pallas kernel), the copied block pool and manager, the
in-place device ops, and the model's ``paged_decode_step`` /
``prefill_step``.  Inputs are made with numpy from seeds and handed to
both frameworks; weights are built by ``repro`` and carried across.

Tolerances: attention f32 1e-4 and bf16 2e-2 (as ``tests/test_paged.py``
holds the Pallas kernel); block copies exact; float32-mode logits 1e-4
and bf16 cache contents to one bf16 ulp (as ``tests/test_torch_dense.py``).
The Hopper kernel itself is held against the plain version in
``tests/test_torch_cuda_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.registry import build_model as jbuild_model
from repro.serving.paged import BlockPool as JBlockPool
from repro.serving.paged import PagedCacheManager as JPagedCacheManager
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.paged import BlockPool, PagedCacheManager
from repro_torch.serving.paged import device as pdev
from repro_torch.serving.sampler import SamplerConfig

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PAGED_CASES = [
    # (B, Hkv, G, D, block_size, max_blocks, lengths) — tests/test_paged.py
    (1, 1, 1, 8, 8, 2, (5,)),
    (3, 2, 4, 16, 8, 4, (5, 17, 32)),
    (2, 2, 8, 32, 16, 3, (1, 48)),
    (2, 1, 3, 16, 8, 4, (9, 25)),
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _paged_inputs(case, seed, garbage=False):
    """Scrambled physical placement, null block 0 for unused entries."""
    B, Hkv, G, D, bs, MB, lens = case
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    q = rng.standard_normal((B, Hkv * G, D), np.float32)
    kp = rng.standard_normal((N, Hkv, bs, D), np.float32)
    vp = rng.standard_normal((N, Hkv, bs, D), np.float32)
    if garbage:
        kp[0], vp[0] = 99.0, -99.0
    perm = iter(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            tables[b, j] = next(perm)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads; one thread
    keeps this module from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ oracle
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_oracle_matches_reference_and_pallas(case, dtype):
    q, kp, vp, tables, lens = _paged_inputs(case, seed=len(case[-1]), garbage=True)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    mine = kpaged.plain(tq, tk, tv, tt, tl)
    via_ops = ops.paged_decode_attention(tq, tk, tv, tt, tl)
    assert mine.dtype == tq.dtype
    np.testing.assert_array_equal(_np(mine), _np(via_ops))
    tol = TOL[dtype]
    for theirs in (jref.paged_decode_attention(jq, jk, jv, jt, jl),
                   jops.paged_decode_attention(jq, jk, jv, jt, jl)):
        np.testing.assert_allclose(_np(mine), _np(theirs), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", PAGED_CASES[1:])
def test_paged_oracle_window_and_lse_match_reference(case):
    """``starts`` masks a prefix (whole blocks below it, and one empty
    window); the lse matches the reference oracle and the Pallas kernel."""
    q, kp, vp, tables, lens = _paged_inputs(case, seed=7)
    starts = (lens // 3).astype(np.int32)
    starts[0] = lens[0] + 1
    j = [jnp.asarray(x) for x in (q, kp, vp, tables, lens, starts)]
    t = [torch.from_numpy(x) for x in (q, kp, vp, tables, lens, starts)]
    out, lse = ops.paged_decode_attention(*t[:5], starts=t[5], return_lse=True)
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30
    assert not torch.isnan(lse).any()
    for theirs, their_lse in (
            jref.paged_decode_attention(*j[:5], starts=j[5], return_lse=True),
            jops.paged_decode_attention(*j[:5], starts=j[5], return_lse=True)):
        np.testing.assert_allclose(_np(out), _np(theirs), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(lse)[1:], _np(their_lse)[1:], atol=1e-4,
                                   rtol=1e-5)


def test_paged_oracle_ignores_null_block_garbage():
    q, kp, vp, tables, lens = _paged_inputs(PAGED_CASES[1], seed=3)
    t = [torch.from_numpy(x) for x in (q, kp, vp, tables, lens)]
    out1 = ops.paged_decode_attention(*t)
    t[1][0], t[2][0] = 99.0, -99.0
    np.testing.assert_array_equal(_np(out1), _np(ops.paged_decode_attention(*t)))


def test_gather_paged_cache_matches_reference():
    q, kp, vp, tables, lens = _paged_inputs(PAGED_CASES[1], seed=4)
    np.testing.assert_array_equal(
        ref.gather_paged_cache(torch.from_numpy(kp), torch.from_numpy(tables)).numpy(),
        np.asarray(jref.gather_paged_cache(jnp.asarray(kp), jnp.asarray(tables))))


def test_naive_decode_window_and_lse_match_reference():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 8, 16), np.float32)
    k = rng.standard_normal((3, 20, 2, 16), np.float32)
    v = rng.standard_normal((3, 20, 2, 16), np.float32)
    lens, starts = np.array([0, 7, 20], np.int32), np.array([0, 3, 19], np.int32)
    out, lse = ref.naive_decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                                          starts=torch.from_numpy(starts),
                                          return_lse=True)
    jout, jlse = jref.naive_decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                             starts=jnp.asarray(starts), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-6)
    assert float(lse[0].max()) <= -1e30 and float(out[0].abs().max()) == 0.0


# ------------------------------------------------------- pool and manager
def _manager_state(mgr):
    pool = mgr.pool
    return (mgr.tables.tolist(), [list(b) for b in mgr.blocks], list(mgr.admit_seq),
            [pool.refcount(b) for b in range(pool.n_blocks)], pool.free_count,
            dataclasses.asdict(pool.stats))


OPS = [
    ("try_admit", 0, np.arange(1, 7)),          # 1 full block + partial
    ("try_admit", 1, np.arange(1, 7)),          # full prefix shared
    ("ensure_append", 0, 6),                    # COW of the shared tail
    ("ensure_append", 1, 6),
    ("ensure_append", 0, 8),                    # boundary block
    ("try_admit", 2, np.arange(20, 36)),        # exact multiple: headroom block
    ("ensure_append", 2, 16),
    ("youngest", {0, 1, 2}),
    ("free_slot", 1),
    ("begin_chunked", 1, np.arange(1, 14)),     # prefix hit on a chunked admit
    ("extend_chunked", 1, 13, 8, False),
    ("extend_chunked", 1, 13, 13, True),
    ("ensure_append", 1, 13),
    ("free_slot", 0),
    ("try_admit", 0, np.arange(40, 75)),        # does not fit: None, no change
    ("free_slot", 2),
    ("free_slot", 1),
]


def test_block_pool_and_manager_copies_match_reference():
    """The same operation sequence gives the same return values, tables,
    block lists, refcounts and PoolStats in the copy and the original."""
    mine = PagedCacheManager(BlockPool(n_blocks=12, block_size=4), 3, 9)
    theirs = JPagedCacheManager(JBlockPool(n_blocks=12, block_size=4), 3, 9)
    for op in OPS:
        name, args = op[0], op[1:]
        args = tuple(a.astype(np.int32) if isinstance(a, np.ndarray) else a
                     for a in args)
        assert getattr(mine, name)(*args) == getattr(theirs, name)(*args), op
        assert _manager_state(mine) == _manager_state(theirs), op
    assert mine.pool.in_use == 0 and mine.pool.stats.cow_copies >= 1
    assert mine.pool.stats.hash_hits >= 2
    a, b = BlockPool(5, 8), JBlockPool(5, 8)
    for pool in (a, b):
        x = pool.alloc()
        pool.register(("k",), x)
        pool.lookup(("k",))
        pool.decref(x)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert a.lookup(("k",)) is None and a.free_count == b.free_count


# ------------------------------------------------------------- device ops
def test_device_block_ops_match_reference_exactly():
    rng = np.random.default_rng(11)
    L, N, Hkv, bs, Dh, S = 2, 6, 2, 4, 8, 16
    pool = {"k": rng.standard_normal((L, N, Hkv, bs, Dh), np.float32),
            "v": rng.standard_normal((L, N, Hkv, bs, Dh), np.float32),
            "block_tables": np.zeros((3, 4), np.int32),
            "lengths": np.zeros(3, np.int32)}
    sub = {"k": rng.standard_normal((L, 2, S, Hkv, Dh), np.float32),
           "v": rng.standard_normal((L, 2, S, Hkv, Dh), np.float32),
           "lengths": np.zeros(2, np.int32)}
    jp = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in sub.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
    for phys, start, lane in ((3, 4, 0), (5, 12, 1), (1, 14, 1)):   # 14: clamped
        jp = jdev.write_prompt_block(jp, js, phys, start, lane)
        pdev.write_prompt_block(tp, ts, phys, start, lane)
    jp = jdev.copy_block(jp, 3, 2)
    pdev.copy_block(tp, 3, 2)
    for phys, start, lane in ((2, 0, 1), (4, 8, 0), (5, 13, 0)):
        js = jdev.read_block(js, jp, phys, start, lane)
        pdev.read_block(ts, tp, phys, start, lane)
    jp = jdev.sync_slot(jp, 1, np.array([4, 2, 0, 0]), 7)
    pdev.sync_slot(tp, 1, np.array([4, 2, 0, 0]), 7)
    for mine, theirs in ((tp, jp), (ts, js)):
        for key in mine:
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]),
                                          err_msg=key)
    tok = torch.zeros(3, dtype=torch.int32)
    pdev.feed_token(tok, 1, torch.tensor([7], dtype=torch.int32))
    eos = pdev.set_stop_id(torch.full((3,), -1, dtype=torch.int32), 0, 5)
    assert tok.tolist() == [0, 7, 0] and eos.tolist() == [5, -1, -1]


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def test_paged_decode_step_matches_reference(models):
    """Three decode steps over a scrambled pool with garbage in null block
    0: an active slot crossing a block boundary, an idle slot, and two idle
    slots at and past the top of the table (whose append index JAX clamps
    to the last column — the null block).  Logits of the active slot
    within 1e-4; the pool outside the null block, tables and lengths as
    the reference's."""
    jmodel, jparams, model, params = models
    cfg = model.cfg
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    B, bs, MB = 4, 4, 4
    N = 1 + B * MB
    rng = np.random.default_rng(12)
    pool_k = _bf16(rng.standard_normal((L, N, Hkv, bs, Dh), np.float32))
    pool_v = _bf16(rng.standard_normal((L, N, Hkv, bs, Dh), np.float32))
    pool_k[:, 0], pool_v[:, 0] = 50.0, -50.0
    tables = np.zeros((B, MB), np.int32)
    tables[0, :2] = [7, 3]                       # slot 0: 6 positions, then block 11
    lengths = np.array([6, 0, 16, 21], np.int32)
    jcache = jmodel.init_paged_cache(B, N, bs, MB)
    jcache = {**jcache, "k": jnp.asarray(pool_k, jnp.bfloat16),
              "v": jnp.asarray(pool_v, jnp.bfloat16),
              "block_tables": jnp.asarray(tables.copy()),
              "lengths": jnp.asarray(lengths)}
    cache = model.init_paged_cache(B, N, bs, MB)
    for key in ("k", "v", "block_tables", "lengths"):
        cache[key].copy_(torch.from_numpy(np.array(jcache[key], np.float32
                                                   if key in ("k", "v") else np.int32)))
    jstep = jax.jit(jmodel.paged_decode_step)
    for t, tok in enumerate(rng.integers(1, cfg.vocab, size=(3, B)).astype(np.int32)):
        if t == 2:                               # block boundary: give slot 0 block 11
            tables[0, 2] = 11
            jcache = jdev.sync_slot(jcache, 0, tables[0].copy())
            pdev.sync_slot(cache, 0, tables[0])
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.paged_decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits[0]), _np(jlogits[0]), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {t}")
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    np.testing.assert_array_equal(cache["block_tables"].numpy(),
                                  np.asarray(jcache["block_tables"]))
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(cache[key][:, 1:]), _np(jcache[key][:, 1:]),
                                   rtol=2**-7, atol=1e-6, err_msg=key)


def test_prefill_step_matches_reference(models):
    """Three chunks of one prompt into slot 1's stripe, the last padded to
    a bucket that runs past the end of the stripe: JAX drops those
    writes, the port skips them.  ``prefill_sample_step`` samples the
    reference's greedy token."""
    jmodel, jparams, model, params = models
    cfg = model.cfg
    S, slot = 16, 1
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, cfg.vocab, size=14).astype(np.int32)
    jcache = jmodel.init_cache(2, S)
    cache = model.init_cache(2, S)
    init = _bf16(rng.standard_normal(cache["k"].shape, np.float32))
    jcache = {**jcache, "k": jnp.asarray(init, jnp.bfloat16)}
    cache["k"].copy_(torch.from_numpy(init))
    jstep = jax.jit(jmodel.prefill_step)
    for start, n_valid, bucket in ((0, 8, 8), (8, 3, 8), (11, 3, 8)):   # 11+8 > 16
        chunk = np.zeros((1, bucket), np.int32)
        chunk[0, :n_valid] = prompt[start:start + n_valid]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(chunk), np.int32(slot),
                                np.int32(start), np.int32(n_valid))
        before = {k: v.clone() for k, v in cache.items()}
        tok, _ = model.prefill_sample_step(params, before, torch.from_numpy(chunk), slot,
                                           start, n_valid, None, sampler=SamplerConfig())
        logits, _ = model.prefill_step(params, cache, torch.from_numpy(chunk), slot,
                                       start, n_valid)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4,
                                   err_msg=f"chunk at {start}")
        assert int(tok[0]) == int(jnp.argmax(jlogits[0]))
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), rtol=2**-7,
                                   atol=1e-6, err_msg=key)
