"""The dense cache's int8 ``kv_quant`` form in the port against the JAX
package (``repro.models.dense``: int8 K/V with bf16 per-vector scales),
on reduced llama3.2-1b with the same weights carried across as numpy.

- The reference's own test, ported: logits within 8% (relative to their
  largest) of the bf16 cache's, and the cache under 0.65x its bytes.
- In float32 mode the int8 payload and the bf16 scales are byte-equal to
  the jitted reference's after a prefill and two decode steps (the
  reference runs jitted, where XLA keeps K's dequantized product in f32
  for the f32 score product: ``models/dense.py:_kv_dequantize``), logits
  within 1e-4; in bf16 within 0.1.
- Float32 engines on the dense decode-only schedule, sync and async, at
  one and two sub-batches: greedy tokens, step stamps and
  ``EngineStats`` equal to the JAX engine's.
- The refusals (hybrid schedule, speculation, ``prefill_step``,
  ``verify_step``) raise the reference's exception types and texts; the
  paged cache maps ``kv_quant`` onto the int8 pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.workload import build_workload

ARCH = "llama3.2-1b"
B, S0, MAX_SEQ = 2, 7, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(dtype: str):
    jcfg = jreduce_config(ARCH).with_overrides(dtype=dtype, kv_quant=True)
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(ARCH).with_overrides(dtype=dtype, kv_quant=True), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x) -> np.ndarray:
    """The stored bytes: int8 payloads as they are, bf16 scales as int16."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.view(jnp.int16) if x.dtype == jnp.bfloat16 else x)


def test_int8_kv_cache_close_and_half_size():
    """tests/test_models.py's criterion: the int8 cache's logits within
    8% of the bf16 cache's, in under 0.65x the bytes."""
    cfg = reduce_config(ARCH)
    m, mq = build_model(cfg, "cpu"), build_model(cfg.with_overrides(kv_quant=True), "cpu")
    params = m.init(0)
    toks = torch.randint(0, cfg.vocab, (B, 13), generator=torch.Generator().manual_seed(1))
    c = m.init_cache(B, 32)
    _, c = m.prefill(params, toks[:, :12], c)
    ref_log, _ = m.decode_step(params, c, toks[:, 12])
    cq = mq.init_cache(B, 32)
    assert cq["k"].dtype == torch.int8 and cq["k_scale"].dtype == torch.bfloat16
    assert cq["k_scale"].shape == (cfg.n_layers, B, 32, cfg.n_kv_heads)
    _, cq = mq.prefill(params, toks[:, :12], cq)
    q_log, _ = mq.decode_step(params, cq, toks[:, 12])
    rel = float((q_log.float() - ref_log.float()).abs().max()) / (
        float(ref_log.float().abs().max()) + 1e-9)
    assert rel < 0.08, rel

    def nbytes(cache):
        return sum(v.numel() * v.element_size() for k, v in cache.items() if k != "lengths")

    assert nbytes(cq) < 0.65 * nbytes(c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_jitted_reference(dtype):
    jmodel, jparams, model, params = _models(dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, MAX_SEQ))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, MAX_SEQ))
    tol = 1e-4 if dtype == "float32" else 1e-1
    steps = [(logits, jlogits)]
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(2):
        tok = rng.integers(1, 512, size=(B,)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        steps.append((logits, jlogits))
    for i, (mine, theirs) in enumerate(steps):
        np.testing.assert_allclose(_np(mine), _np(theirs), atol=tol, rtol=tol,
                                   err_msg=f"step {i}")
    assert cache["lengths"].tolist() == [S0 + 2] * B
    for key in ("k", "v", "k_scale", "v_scale"):
        assert cache[key].dtype == (torch.int8 if key in "kv" else torch.bfloat16)
        if dtype == "float32":
            np.testing.assert_array_equal(_bits(cache[key]), _bits(jcache[key]), err_msg=key)


def test_quantizer_is_the_jitted_references():
    from repro.models import dense as jdense
    from repro_torch.models import dense
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 3, 16)).astype(np.float32) * rng.uniform(1e-3, 30, (64, 3, 1))
    x[0, 0] = 0.0
    jq, js = jax.jit(jdense._kv_quantize)(jnp.asarray(x))
    q, s = dense._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    deq = jax.jit(jdense._kv_dequantize)(jq, js)
    np.testing.assert_array_equal(_bits(dense._kv_dequantize(q, s)), _bits(deq))


def _run(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, n_slots=4, max_seq=64, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


@pytest.mark.parametrize("sub_batches", [1, 2])
@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_engine_matches_reference(f32_models, async_mode, sub_batches):
    jmodel, jparams, model, params = f32_models
    prompts = [a.prompt for a in build_workload("random", 8, vocab=512, max_seq=64,
                                                max_new=8, seed=3)]
    kw = dict(async_mode=async_mode, sub_batches=sub_batches)
    jreqs, jstats, jeng = _run(JEngine, JRequest, jmodel, jparams, prompts, **kw)
    reqs, stats, eng = _run(Engine, Request, model, params, prompts, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert eng.kv_bytes() == jeng.kv_bytes()
    assert stats.prefills == 8 and stats.decode_steps > 0


@pytest.mark.parametrize("kw", [
    dict(schedule="hybrid"),
    dict(schedule="hybrid", cache_kind="paged"),
    dict(spec_depth=2),
], ids=["hybrid", "paged-hybrid", "spec"])
def test_engine_refusals_match_reference(f32_models, kw):
    jmodel, jparams, model, params = f32_models
    jkw, tkw = dict(kw), dict(kw)
    if "spec_depth" in kw:
        jkw.update(draft_model=jmodel, draft_params=jparams)
        tkw.update(draft_model=model, draft_params=params)
    with pytest.raises(Exception) as theirs:
        JEngine(jmodel, jparams, n_slots=2, max_seq=32, **jkw)
    with pytest.raises(Exception) as mine:
        Engine(model, params, n_slots=2, max_seq=32, **tkw)
    assert type(mine.value) is type(theirs.value) is NotImplementedError
    assert str(mine.value) == str(theirs.value)


def test_step_refusals_match_reference(f32_models):
    jmodel, jparams, model, params = f32_models
    tokens = np.ones((1, 4), np.int32)
    calls = {
        "prefill_step": (lambda: jmodel.prefill_step(jparams, jmodel.init_cache(2, 16),
                                                     jnp.asarray(tokens), 0, 0, 4),
                         lambda: model.prefill_step(params, model.init_cache(2, 16),
                                                    torch.from_numpy(tokens), 0, 0, 4)),
        "verify_step": (lambda: jmodel.verify_step(jparams, jmodel.init_cache(1, 16),
                                                   jnp.asarray(tokens)),
                        lambda: model.verify_step(params, model.init_cache(1, 16),
                                                  torch.from_numpy(tokens))),
    }
    for name, (theirs, mine) in calls.items():
        with pytest.raises(NotImplementedError) as a:
            theirs()
        with pytest.raises(NotImplementedError) as b:
            mine()
        assert str(a.value) == str(b.value), name


def test_paged_cache_maps_kv_quant_onto_the_int8_pool(f32_models):
    jmodel, _, model, _ = f32_models
    jc = jmodel.init_paged_cache(2, 9, 8, 4)
    c = model.init_paged_cache(2, 9, 8, 4)
    assert set(c) == set(jc)
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["k_scale"].dtype == c["v_scale"].dtype == torch.float32
    for k in c:
        assert tuple(c[k].shape) == tuple(jc[k].shape), k
        assert str(c[k].dtype).split(".")[-1] == str(jc[k].dtype), k
