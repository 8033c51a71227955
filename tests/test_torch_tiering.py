"""The port's tiered KV against the JAX package: the fp8/int8 quantizer,
the scaled paged and flash oracles (against ``repro.kernels.ref`` and the
interpret-mode Pallas kernels), ``lse_merge``, the quantizing and
host-tier device ops, ``paged_decode_step`` over quantized and hosted
pools, and the engine with fp8/int8 pools and the host tier.  Inputs are
made with numpy from seeds and handed to both frameworks; weights are
built by ``repro`` and carried across.

Tolerances: quantized payloads and scales byte-exact where both sides
quantize the same numbers; attention f32 1e-4 (as ``tests/test_paged.py``
and ``tests/test_kv_tiering.py``); float32-mode logits 1e-4; a pool
written from activations that the two frameworks compute to within
rounding may differ by one quantization code; engine tokens, step stamps,
``EngineStats`` and ``PoolStats`` exact.

The reference engine runs with one race removed (``_copied_rows``): its
``device.sync_slot`` and ``sync_host_slot`` push numpy rows through
``jnp.asarray``, which on the CPU may alias a row that the manager then
rewrites in place (see ``tests/test_torch_hybrid.py``).  The test hands
it copies, which is what its code means.
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
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops, ref
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged import device as pdev

KV = ["fp8", "int8"]
TORCH_KV = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}
SCHEDULES = {"decode-only": {}, "hybrid": dict(schedule="hybrid", prefill_chunk=8)}
MODES = {"sync": False, "async": True}
PAGED_CASES = [
    # (B, Hkv, G, D, block_size, max_blocks, lengths) — tests/test_paged.py
    (3, 2, 4, 16, 8, 4, (5, 17, 32)),
    (2, 2, 8, 32, 16, 3, (1, 48)),
    (2, 1, 3, 16, 8, 4, (9, 25)),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_rows(monkeypatch):
    push, push_host = jdev.sync_slot, jdev.sync_host_slot

    def sync_slot(cache, slot, row, length=None):
        return push(cache, slot, np.array(row, np.int32), length)

    def sync_host_slot(cache, slot, row, cold_len):
        return push_host(cache, slot, np.array(row, np.int32), cold_len)

    monkeypatch.setattr(jdev, "sync_slot", sync_slot)
    monkeypatch.setattr(jdev, "sync_host_slot", sync_host_slot)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bytes (fp8 included)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _codes(x) -> np.ndarray:
    """Quantized payload -> signed code index (adjacent codes differ by 1)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.uint8) if x.dtype == jnp.float8_e4m3fn else x
    if x.dtype == np.uint8:           # fp8-e4m3: sign bit + ordered magnitude code
        mag = (x & 0x7F).astype(np.int32)
        return np.where(x & 0x80, -mag, mag)
    return x.astype(np.int32)


def _bytes_equal(mine: torch.Tensor, theirs, msg: str = "") -> None:
    np.testing.assert_array_equal(ref.byte_view(mine).numpy(),
                                  _torch(theirs).view(torch.uint8).numpy()
                                  if mine.dtype == torch.float8_e4m3fn
                                  else np.asarray(theirs), err_msg=msg)


# ---------------------------------------------------------------- quantizer
@pytest.mark.parametrize("kv", KV)
def test_kv_quantize_is_byte_exact_against_reference(kv):
    """Random vectors over a wide dynamic range, a zero vector, and int8
    ties (x / scale exactly k + 1/2) that must round half to even, against
    the reference quantizer as every caller in the reference runs it:
    jitted (XLA computes ``amax / qmax`` as ``amax * (1 / qmax)``)."""
    jquant = jax.jit(jref.kv_quantize, static_argnames="kv_dtype")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 4, 64)) * np.exp(rng.standard_normal((6, 4, 1)) * 3)
         ).astype(np.float32)
    x[1, 2] = 0.0                                   # zero vector: scale 0, payload 0
    x[2, 0, :] = np.arange(64) - 31.5               # amax 31.5 ...
    x[2, 0, 0] = 127.0                              # ... now 127: scale 1, ties at k + .5
    jp, js = jquant(jnp.asarray(x), kv_dtype=kv)
    p, s = ref.kv_quantize(torch.from_numpy(x), kv)
    assert p.dtype == TORCH_KV[kv] and s.dtype == torch.float32
    _bytes_equal(p, jp)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[1, 2]) == 0.0 and not ref.byte_view(p[1, 2]).any()
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(ref.kv_dequantize(p, s, dt)),
                                      _np(jref.kv_dequantize(jp, js, jdt)))
    # and from a bf16 input, as the staging cache hands it over
    xb = jnp.asarray(x, jnp.bfloat16)
    jp, js = jquant(xb, kv_dtype=kv)
    p, s = ref.kv_quantize(torch.from_numpy(x).bfloat16(), kv)
    _bytes_equal(p, jp)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ------------------------------------------------------------ scaled oracles
def _quantized_paged_inputs(case, kv, seed):
    """Quantized pools (quantized by the reference) over a scrambled table,
    with finite garbage in null block 0 of the payload and scale pools."""
    B, Hkv, G, D, bs, MB, lens = case
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    q = rng.standard_normal((B, Hkv * G, D), np.float32)
    kf = rng.standard_normal((N, Hkv, bs, D), np.float32) * 2
    vf = rng.standard_normal((N, Hkv, bs, D), np.float32) * 2
    kf[0], vf[0] = 40.0, -40.0
    kp, ks = jref.kv_quantize(jnp.asarray(kf), kv)
    vp, vs = jref.kv_quantize(jnp.asarray(vf), kv)
    ks, vs = ks.at[0].set(7.5), vs.at[0].set(-3.0)          # garbage scales too
    perm = iter(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            tables[b, j] = next(perm)
    return q, (kp, vp, ks, vs), tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_scaled_paged_oracle_matches_reference_and_pallas(case, kv):
    """``ops.paged_decode_attention`` with scale pools (the CPU plain
    version) against the jnp oracle and the interpret-mode Pallas kernel,
    plain and with a ``starts`` window and lse (row 0's window empty)."""
    q, jpools, tables, lens = _quantized_paged_inputs(case, kv, seed=len(case[6]))
    tq = torch.from_numpy(q)
    kp, vp, ks, vs = (_torch(a) for a in jpools)
    jq, jt, jl = jnp.asarray(q), jnp.asarray(tables), jnp.asarray(lens)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    out = ops.paged_decode_attention(tq, kp, vp, tt, tl, k_scale=ks, v_scale=vs)
    jk, jv, jks, jvs = jpools
    for exp in (jref.paged_decode_attention(jq, jk, jv, jt, jl, k_scale=jks, v_scale=jvs),
                jops.paged_decode_attention(jq, jk, jv, jt, jl, k_scale=jks, v_scale=jvs)):
        np.testing.assert_allclose(_np(out), _np(exp), atol=1e-4, rtol=1e-4)
    starts = lens // 3
    starts[0] = lens[0] + 1
    out, lse = ops.paged_decode_attention(tq, kp, vp, tt, tl, starts=torch.from_numpy(starts),
                                          return_lse=True, k_scale=ks, v_scale=vs)
    for fn in (jref.paged_decode_attention, jops.paged_decode_attention):
        exp, exp_lse = fn(jq, jk, jv, jt, jl, starts=jnp.asarray(starts), k_scale=jks,
                          v_scale=jvs, return_lse=True)
        np.testing.assert_allclose(_np(out), _np(exp), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(lse)[1:], _np(exp_lse)[1:], atol=1e-4, rtol=1e-4)
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 16), (False, 0)])
def test_scaled_flash_oracle_matches_reference_and_pallas(kv, causal, q_offset):
    """``ops.flash_attention`` with (B, Sk, Hkv) scales (the CPU plain
    version) against ``ref.naive_attention(k_scale=...)`` and the
    interpret-mode ``flash_attention_pallas`` (block sizes divide Sq, Sk)."""
    B, Sq, Hkv, G, D = 2, 16, 2, 2, 32
    Sk = Sq + q_offset
    rng = np.random.default_rng(Sk + causal)
    q = rng.standard_normal((B, Sq, Hkv * G, D), np.float32)
    jk, jks = jref.kv_quantize(jnp.asarray(rng.standard_normal((B, Sk, Hkv, D)) * 3), kv)
    jv, jvs = jref.kv_quantize(jnp.asarray(rng.standard_normal((B, Sk, Hkv, D)) * 3), kv)
    out = ops.flash_attention(torch.from_numpy(q), _torch(jk), _torch(jv), causal=causal,
                              q_offset=q_offset, k_scale=_torch(jks), v_scale=_torch(jvs))
    jq = jnp.asarray(q)
    for exp in (jref.naive_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                     k_scale=jks, v_scale=jvs),
                jops.flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                     block_q=8, block_k=8, k_scale=jks, v_scale=jvs)):
        np.testing.assert_allclose(_np(out), _np(exp), atol=1e-4, rtol=1e-4)


def test_lse_merge_matches_reference_and_hot_cold_is_full_attention():
    """``lse_merge`` of random partials against the reference (an empty
    window among them), and the hybrid split: the cold prefix in a host
    pool plus the hot window of the device pool, merged, is attention
    over the whole sequence."""
    rng = np.random.default_rng(3)
    B, Hkv, G, D = 3, 2, 4, 16
    parts = [(rng.standard_normal((B, Hkv * G, D), np.float32),
              rng.standard_normal((B, Hkv, G), np.float32) * 3) for _ in range(3)]
    parts[1][1][0] = -1e30 - 50.0                                  # an empty window
    mine = ref.lse_merge([(torch.from_numpy(o), torch.from_numpy(l)) for o, l in parts])
    theirs = jref.lse_merge([(jnp.asarray(o), jnp.asarray(l)) for o, l in parts])
    np.testing.assert_allclose(_np(mine), _np(theirs), atol=1e-6, rtol=1e-6)
    empty = [(torch.zeros(1, 2, 4), torch.full((1, 1, 2), -1e30 - 69.0))] * 2
    assert float(ref.lse_merge(empty).abs().max()) == 0.0      # all empty: 0, not NaN

    case = (3, 2, 4, 16, 8, 4, (5, 17, 32))
    for kv in KV:
        q, jpools, tables, lens = _quantized_paged_inputs(case, kv, seed=9)
        tq, tt, tl = (torch.from_numpy(a) for a in (q, tables, lens))
        kp, vp, ks, vs = (_torch(a) for a in jpools)
        cold = torch.tensor([0, 8, 24], dtype=torch.int32)          # whole blocks spilled
        host = {k: torch.zeros_like(x) for k, x in zip("KVST", (kp, vp, ks, vs))}
        htables = torch.zeros_like(tt)
        for b in range(3):
            for j in range(int(cold[b]) // 8):
                hb = 1 + b * 4 + j
                for key, src in zip("KVST", (kp, vp, ks, vs)):
                    pdev._copy(host[key][hb], src[tables[b, j]])
                htables[b, j] = hb
        full = ops.paged_decode_attention(tq, kp, vp, tt, tl, k_scale=ks, v_scale=vs)
        hot = ops.paged_decode_attention(tq, kp, vp, tt, tl, starts=cold, return_lse=True,
                                         k_scale=ks, v_scale=vs)
        cold_part = ops.paged_decode_attention(tq, host["K"], host["V"], htables, cold,
                                               return_lse=True, k_scale=host["S"],
                                               v_scale=host["T"])
        np.testing.assert_allclose(_np(ref.lse_merge([hot, cold_part])), _np(full),
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- device ops
def _tiered_pools(kv, rng, L=2, N=6, HN=4, Hkv=2, bs=4, Dh=16):
    """The same random tiered pool for both frameworks (quantized by the
    reference), and a bf16 two-lane staging cache."""
    kf = jnp.asarray(rng.standard_normal((L, N, Hkv, bs, Dh)), jnp.float32)
    vf = jnp.asarray(rng.standard_normal((L, N, Hkv, bs, Dh)), jnp.float32)
    jk, jks = jref.kv_quantize(kf, kv)
    jv, jvs = jref.kv_quantize(vf, kv)
    jp = {"k": jk, "v": jv, "k_scale": jks, "v_scale": jvs}
    for key in ("k", "v", "k_scale", "v_scale"):     # distinct buffers: JAX donates them
        jp[f"host_{key}"] = jnp.zeros((L, HN) + jp[key].shape[2:], jp[key].dtype)
    jp |= {
          "block_tables": jnp.zeros((3, 4), jnp.int32), "lengths": jnp.zeros(3, jnp.int32),
          "host_tables": jnp.zeros((3, 4), jnp.int32),
          "cold_lengths": jnp.zeros(3, jnp.int32)}
    S = 16
    sub = {"k": jnp.asarray(rng.standard_normal((L, 2, S, Hkv, Dh)) * 2, jnp.bfloat16),
           "v": jnp.asarray(rng.standard_normal((L, 2, S, Hkv, Dh)) * 2, jnp.bfloat16),
           "lengths": jnp.zeros(2, jnp.int32)}
    return jp, sub


def _tensors(tree):
    return {k: _torch(v) if v.dtype != jnp.bfloat16 else
            torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()
            for k, v in tree.items()}


def _assert_same_leaves(mine, theirs):
    for key, t in mine.items():
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_np(t), _np(theirs[key]), err_msg=key)
        else:
            _bytes_equal(t, theirs[key], key)


@pytest.mark.parametrize("kv", KV)
def test_tiered_device_ops_match_reference_exactly(kv):
    """Quantizing block writes (a clamped start included), COW with
    scales, dequantizing staging reads, spill to the host tier, rehydrate
    after the device copy was clobbered, and ``sync_host_slot``: every
    leaf byte-identical to the reference's."""
    rng = np.random.default_rng(21)
    jp, js = _tiered_pools(kv, rng)
    tp, ts = _tensors(jp), _tensors(js)
    for phys, start, lane in ((3, 4, 0), (5, 12, 1), (1, 14, 1)):     # 14: clamped
        jp = jdev.write_prompt_block(jp, js, phys, start, lane)
        pdev.write_prompt_block(tp, ts, phys, start, lane)
    jp = jdev.copy_block(jp, 3, 2)
    pdev.copy_block(tp, 3, 2)
    for phys, start, lane in ((2, 0, 1), (4, 8, 0), (5, 13, 0)):
        js = jdev.read_block(js, jp, phys, start, lane)
        pdev.read_block(ts, tp, phys, start, lane)
    for dev, host in ((2, 1), (5, 3)):
        jp = jdev.spill_block(jp, dev, host)
        pdev.spill_block(tp, dev, host)
    for key in ("k", "v", "k_scale", "v_scale"):                      # clobber block 2
        jp[key] = jp[key].at[:, 2].set(0)
        ref.byte_view(tp[key])[:, 2].zero_()
    jp = jdev.rehydrate_block(jp, 1, 2)
    pdev.rehydrate_block(tp, 1, 2)
    row = np.array([1, 3, 0, 0], np.int32)
    jp = jdev.sync_host_slot(jp, 2, row.copy(), 8)
    pdev.sync_host_slot(tp, 2, row, 8)
    row[:] = 9                                   # the push took a copy
    _assert_same_leaves(tp, jp)
    _assert_same_leaves(ts, js)
    assert tp["cold_lengths"].tolist() == [0, 0, 8]


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("hosted", [False, True], ids=["device", "hosted"])
@pytest.mark.parametrize("kv", KV)
def test_paged_decode_step_quantized_matches_reference(models, kv, hosted):
    """Three decode steps over a quantized pool (garbage in null block 0
    of payload and scale pools): an active slot crossing a block
    boundary, an idle slot, and idle slots at and past the top of the
    table.  ``hosted``: slot 0's first block and slot 3's first two live
    in the host pool (``cold_lengths`` 4 and 8), so each layer merges the
    hot and cold windows.  Logits of the active slots within 1e-4; the
    appended codes within one quantization step, scales within 1e-5."""
    jmodel, jparams, model, params = models
    cfg = model.cfg
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    B, bs, MB, HN = 5, 4, 4, 6
    N = 1 + B * MB
    rng = np.random.default_rng(12)
    jcache = jmodel.init_paged_cache(B, N, bs, MB, kv_dtype=kv,
                                     host_blocks=HN - 1 if hosted else 0)
    for key, n in (("k", N), ("v", N)) + ((("host_k", HN), ("host_v", HN)) if hosted else ()):
        x = jnp.asarray(rng.standard_normal((L, n, Hkv, bs, Dh)), jnp.float32)
        payload, scale = jref.kv_quantize(x, kv)
        jcache[key], jcache[f"{key}_scale"] = payload, scale.at[:, 0].set(5.0)
    tables = np.zeros((B, MB), np.int32)
    tables[0, :2] = [7, 3]                        # slot 0: 6 positions, then block 11
    tables[3] = [5, 14, 9, 12]                    # slot 3: 13 positions, appends in block 12
    # slot 1 idle; slots 2 and 4 idle past and at the top of the table
    lengths = np.array([6, 0, 21, 13, 16], np.int32)
    jcache |= {"block_tables": jnp.asarray(tables.copy()), "lengths": jnp.asarray(lengths)}
    if hosted:
        jcache["host_tables"] = jnp.asarray(np.array(
            [[2, 0, 0, 0], [0] * 4, [0] * 4, [4, 1, 0, 0], [0] * 4], np.int32))
        jcache["cold_lengths"] = jnp.asarray(np.array([4, 0, 0, 8, 0], np.int32))
        tables[0, 0] = 0                          # spilled: the device entry is null
        tables[3, :2] = 0
        jcache["block_tables"] = jnp.asarray(tables.copy())
    cache = model.init_paged_cache(B, N, bs, MB, kv_dtype=kv,
                                   host_blocks=HN - 1 if hosted else 0)
    assert set(cache) == set(jcache)
    for key, t in cache.items():
        assert t.shape == jcache[key].shape, key
        ref.byte_view(t).copy_(ref.byte_view(_torch(jcache[key])))
    jstep = jax.jit(jmodel.paged_decode_step)
    active = [0, 3]
    for t, tok in enumerate(rng.integers(1, cfg.vocab, size=(3, B)).astype(np.int32)):
        if t == 2:                                # block boundary: give slot 0 block 11
            tables[0, 2] = 11
            jcache = jdev.sync_slot(jcache, 0, tables[0].copy())
            pdev.sync_slot(cache, 0, tables[0])
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.paged_decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits[active]), _np(jlogits[np.array(active)]),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        assert cache[key].dtype == TORCH_KV[kv]
        diff = np.abs(_codes(cache[key][:, 1:]) - _codes(jcache[key][:, 1:]))
        assert diff.max() <= 1, key
        np.testing.assert_allclose(cache[f"{key}_scale"][:, 1:].numpy(),
                                   np.asarray(jcache[f"{key}_scale"][:, 1:]), rtol=1e-5,
                                   err_msg=key)
    for key in cache:
        if key.startswith("host"):
            _bytes_equal(cache[key], jcache[key], key)   # decode never writes the host tier


# ----------------------------------------------------------------- engine
SPILL = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
# a third request that takes the slot the first spilled from: the first's
# prompt again (its freed prefix re-hydrates), or another prompt
REPEAT = SPILL + [SPILL[0]]
OTHER = SPILL + [np.arange(40, 49, dtype=np.int32)]
TIGHT = dict(cache_kind="paged", block_size=4, n_blocks=9, host_blocks=8)


def _run(engine_cls, request_cls, model, params, prompts, n_new, n_slots=2, **kw):
    eng = engine_cls(model, params, n_slots=n_slots, max_seq=32, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


def _same(models, prompts, n_new, tokens=True, **kw):
    """Both engines on one workload: step stamps, ``EngineStats`` and
    ``PoolStats`` equal, and (``tokens``) greedy tokens equal.  Returns
    the port's requests, stats and engine."""
    jmodel, jparams, model, params = models
    jreqs, jstats, jeng = _run(JEngine, JRequest, jmodel, jparams, prompts, n_new, **kw)
    reqs, stats, eng = _run(Engine, Request, model, params, prompts, n_new, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0 and r.in_flight_steps == 0
        if tokens:
            assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
    assert eng.pool.in_use == 0 and eng.kv_bytes() == jeng.kv_bytes()
    return reqs, stats, eng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kv", KV)
def test_quantized_tiered_engine_matches_reference(models, kv, schedule, mode):
    """fp8/int8 pools with the host tier on a pool too small for both
    sequences: live spills instead of preemptions, the freed prefix
    spills at free time and re-hydrates as a cache hit for the third
    request (the first's prompt again, in the slot the first spilled
    from, so the port's reset of that slot's cold window changes
    nothing here)."""
    _, stats, _ = _same(models, REPEAT, 10, async_mode=MODES[mode], kv_dtype=kv,
                        **TIGHT, **SCHEDULES[schedule])
    assert stats.spills >= 1 and stats.rehydrations >= 1 and stats.preemptions == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_host_tier_spills_instead_of_preempting_as_reference(models, schedule, mode):
    """``tests/test_kv_tiering.py``'s spill scenario: spills, no
    preemption, and the greedy tokens of the unspilled run."""
    _, _, model, params = models
    base, _, _ = _run(Engine, Request, model, params, SPILL, 10, cache_kind="paged",
                      block_size=4)
    reqs, stats, _ = _same(models, SPILL, 10, async_mode=MODES[mode], **TIGHT,
                           **SCHEDULES[schedule])
    assert stats.spills >= 1 and stats.preemptions == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base]


def test_host_tier_rehydrates_freed_prefix_as_reference(models):
    """``tests/test_kv_tiering.py``'s rehydration scenario: a finished
    prefix spills at free time and comes back for the same prompt."""
    jmodel, jparams, model, params = models
    runs = []
    for engine_cls, request_cls, m, p in ((JEngine, JRequest, jmodel, jparams),
                                          (Engine, Request, model, params)):
        eng = engine_cls(m, p, n_slots=1, max_seq=32, cache_kind="paged", block_size=4,
                         host_blocks=8)
        reqs = []
        for uid in range(2):
            reqs.append(request_cls(uid=uid, prompt=SPILL[0], max_new_tokens=5))
            eng.submit(reqs[-1])
            eng.run()
        runs.append((reqs, eng))
    (jreqs, jeng), (reqs, eng) = runs
    assert eng.pool.stats.spills >= 2 and eng.stats.rehydrations >= 2
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert reqs[1].out_tokens == reqs[0].out_tokens
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)


@pytest.mark.parametrize("mode", MODES)
def test_reused_spilled_slot_starts_with_an_empty_cold_window(models, mode):
    """A request admitted into a slot whose previous request had spilled:
    the port pushes the freed slot's empty host row and cold length 0, so
    the newcomer decodes the tokens of an unspilled run.  (The reference
    keeps the old cold length on the device, and its third request's
    tokens differ from its own unspilled run's; its step clock and pool
    stats still equal the port's.)"""
    jmodel, jparams, model, params = models
    base, _, _ = _run(JEngine, JRequest, jmodel, jparams, OTHER, 10, cache_kind="paged",
                      block_size=4)
    reqs, stats, _ = _same(models, OTHER, 10, tokens=False, async_mode=MODES[mode],
                           **TIGHT)
    assert stats.spills >= 1 and stats.preemptions == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base]
