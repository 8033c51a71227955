"""The dense family's other registered architectures in the port against
the JAX package, with the same weights (built by ``repro``, carried
across as numpy): reduced yi-34b, llama3.2-3b, minicpm-2b and
internvl2-76b's backbone.

- A prefill, then four decode steps: logits within 1e-4 in float32 mode
  and 0.1 in bf16, and the cache to one bf16 ulp in float32 mode, as
  ``tests/test_torch_dense.py`` holds llama3.2-1b.
- At an odd vocabulary (509, padded to 512) the pad logits are masked
  in both.
- ``prefill(..., embeds=)`` (internvl2-76b's stub frontend; moonshot's
  MoE prefill) against the reference's, and, in the port, prefilling
  ``embed[u]`` before ``t`` equals prefilling ``u + t``, bit for bit.
- Float32 engines (dense decode-only and paged hybrid, sync and async):
  greedy tokens, step stamps, ``EngineStats`` and ``PoolStats`` equal to
  the JAX engine's.  The reference's paged engine runs with copied table
  rows (``_copied_table_rows``, as in ``tests/test_torch_hybrid.py``).
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
from repro.serving.paged import device as jdev
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request

ARCHS = ["yi-34b", "llama3.2-3b", "minicpm-2b", "internvl2-76b"]
B, S0, MAX_SEQ, N_DECODE = 2, 7, 16, 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 13, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32), np.arange(1, 17, dtype=np.int32),
           np.arange(4, 25, dtype=np.int32)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_table_rows(monkeypatch):
    push = jdev.sync_slot

    def sync_slot(cache, slot, row, length=None):
        return push(cache, slot, np.array(row, np.int32), length)

    monkeypatch.setattr(jdev, "sync_slot", sync_slot)


def _models(arch, dtype, **kw):
    jcfg = jreduce_config(arch, **kw).with_overrides(dtype=dtype)
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(arch, **kw).with_overrides(dtype=dtype), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_the_four_configs_are_the_references():
    from repro.configs import get_config as jget_config
    for arch in ARCHS:
        mine, theirs = get_config(arch), jget_config(arch)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), (arch, f.name)
        assert reduce_config(arch).frontend_len == jreduce_config(arch).frontend_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, dtype):
    jmodel, jparams, model, params = _models(arch, dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    steps = rng.integers(1, 512, size=(N_DECODE, B)).astype(np.int32)
    tol = LOGIT_TOL[dtype]
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, MAX_SEQ))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, MAX_SEQ))
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(N_DECODE):
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(steps[t]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(steps[t]))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol,
                                   err_msg=f"decode step {t}")
    n = S0 + N_DECODE
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key][:, :, :n]), _np(jcache[key][:, :, :n]),
                                   rtol=2**-7, atol=1e-6 if dtype == "float32" else tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_odd_vocab_pad_logits_are_masked(arch):
    jmodel, jparams, model, params = _models(arch, "float32", vocab=509)
    assert model.cfg.padded_vocab() == 512 and params["embed"].shape[0] == 512
    prompt = np.arange(3, 12, dtype=np.int32)[None]
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(1, MAX_SEQ))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(1, MAX_SEQ))
    tok = np.array([508], np.int32)
    jlogits2, _ = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(tok))
    logits2, _ = model.decode_step(params, cache, torch.from_numpy(tok))
    for mine, theirs in ((logits, jlogits), (logits2, jlogits2)):
        assert mine.shape == (1, 512)
        assert bool((mine[:, 509:] == -1e30).all())
        np.testing.assert_array_equal(_np(theirs)[:, 509:], _np(mine)[:, 509:])
        np.testing.assert_allclose(_np(mine)[:, :509], _np(theirs)[:, :509],
                                   atol=1e-4, rtol=1e-4)
        assert int(mine.argmax(-1)) < 509


def _embeds(params, n: int, seed: int) -> np.ndarray:
    """Stand-in frontend embeddings: rows of the embedding table."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 509, size=(B, n)).astype(np.int32)
    return u, params["embed"][torch.from_numpy(u).long()].float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_embeds_matches_reference(dtype):
    jmodel, jparams, model, params = _models("internvl2-76b", dtype)
    F = model.cfg.frontend_len
    assert F == 8
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, F, model.cfg.d_model)).astype(np.float32) * 0.02
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, jnp.asarray(prompt), jmodel.init_cache(B, MAX_SEQ),
        embeds=jnp.asarray(emb, getattr(jnp, dtype)))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, MAX_SEQ),
                                  embeds=torch.from_numpy(emb).to(getattr(torch, dtype)))
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist() == [F + S0] * B
    n = F + S0
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key][:, :, :n]), _np(jcache[key][:, :, :n]),
                                   rtol=2**-7, atol=1e-6 if dtype == "float32" else tol)
    # then decoding continues after the frontend positions
    tok = np.array([5, 6], np.int32)
    jlogits, _ = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(tok))
    logits, _ = model.decode_step(params, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedded_tokens_prefill_like_the_tokens(dtype):
    """``prefill(t, embeds=embed[u])`` is ``prefill(u + t)`` bit for bit:
    logits, cache and lengths."""
    _, _, model, params = _models("internvl2-76b", dtype)
    u, _ = _embeds(params, model.cfg.frontend_len, 2)
    t = np.random.default_rng(3).integers(1, 512, size=(B, S0)).astype(np.int32)
    emb = params["embed"][torch.from_numpy(u).long()]
    a_logits, a = model.prefill(params, torch.from_numpy(t), model.init_cache(B, MAX_SEQ),
                                embeds=emb)
    b_logits, b = model.prefill(params, torch.from_numpy(np.concatenate([u, t], 1)),
                                model.init_cache(B, MAX_SEQ))
    assert torch.equal(a_logits, b_logits)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert a["lengths"].tolist() == [u.shape[1] + S0] * B


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_with_embeds_matches_reference(dtype):
    jmodel, jparams, model, params = _models("moonshot-v1-16b-a3b", dtype)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((B, 5, model.cfg.d_model)).astype(np.float32) * 0.02
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, jnp.asarray(prompt), jmodel.init_cache(B, MAX_SEQ),
        embeds=jnp.asarray(emb, getattr(jnp, dtype)))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, MAX_SEQ),
                                  embeds=torch.from_numpy(emb).to(getattr(torch, dtype)))
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)
    assert cache["lengths"].tolist() == [5 + S0] * B
    # the whole cache in float32; in bf16 the dense first layer's only: a
    # bf16 rounding may route a token to another expert, whose K/V then
    # differ in the later layers (tests/test_torch_moe.py's finding)
    layers = slice(None) if dtype == "float32" else slice(0, model.cfg.moe.moe_layer_start)
    n = 5 + S0
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key][layers, :, :n]),
                                   _np(jcache[key][layers, :, :n]),
                                   rtol=2**-7, atol=1e-6 if dtype == "float32" else tol)


def _run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, n_slots=2, max_seq=32, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


@pytest.fixture(scope="module")
def f32_models():
    return {arch: _models(arch, "float32") for arch in ARCHS}


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("path", ["dense", "paged-hybrid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(f32_models, arch, path, mode):
    jmodel, jparams, model, params = f32_models[arch]
    kw = dict(async_mode=mode == "async")
    if path == "paged-hybrid":
        kw |= dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8)
    jreqs, jstats, jeng = _run(JEngine, JRequest, jmodel, jparams, **kw)
    reqs, stats, eng = _run(Engine, Request, model, params, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    if path == "paged-hybrid":
        assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
        assert eng.pool.in_use == 0
