"""The port's RWKV6 family against the JAX package with the same weights and
inputs (made with numpy or by ``repro``, carried across as numpy), on
reduced rwkv6-7b (2 layers, d 64, heads of 16, LoRA ranks 8): the config
and parameter tree, the time-mix pieces (``_ddlerp``, ``_decay``, the WKV
recurrence on both of the reference's branches, the per-head group norm),
the layer norm, and a prefill followed by decode steps, logits and every
cache leaf.

Tolerances: the f32 pieces 1e-5 (f32 sums in other orders); logits 1e-4
in float32 mode and 0.1 in bf16, as ``tests/test_torch_dense.py`` holds
the dense family's; the cache in float32 mode 1e-5 (every leaf is f32:
the shifts hold the model's dtype, ROADMAP §3), in bf16 0.1 absolute plus
2**-4 relative, where both frameworks round activations at other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models import common as jcm
from repro.models import rwkv6 as jrwkv6
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import common as cm
from repro_torch.models import rwkv6
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model

ARCH = "rwkv6-7b"
B, S0, N_DECODE = 2, 7, 3
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-4, atol=1e-1)}
N_PARAMS = 7577026560


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(dtype):
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype=dtype), Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(ARCH).with_overrides(dtype=dtype), "cpu")
    return jmodel, jparams, model, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_config_and_params_match_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_config(ARCH), jreduce_config(ARCH))):
        assert cfg.rwkv.__dict__ == jcfg.rwkv.__dict__
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "norm_eps", "dtype", "attention_offload",
                  "subquadratic"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        shapes = jax.tree.map(lambda d: d.shape, jrwkv6.param_defs(jcfg), is_leaf=jcm.is_def)
        mine = jax.tree.map(lambda d: d.shape, rwkv6.param_defs(cfg),
                            is_leaf=lambda d: isinstance(d, cm.ParamDef))
        assert mine == shapes
        assert cm.count_params(rwkv6.param_defs(cfg)) == jcm.count_params(
            jrwkv6.param_defs(jcfg))
    assert build_model(get_config(ARCH), "cpu").n_params() == N_PARAMS


def _layer(dtype="float32"):
    """Layer 0 of reduced rwkv6-7b's seed-0 weights in both frameworks, its
    "small" LoRAs scaled up so that the data-dependent terms matter."""
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype=dtype), Env())
    jp = jax.tree.map(lambda a: a[0], jmodel.init(jax.random.key(0))["blocks"])
    for k in ("tm_a", "tm_b", "w1", "w2", "u"):
        jp[k] = jp[k] * 3000
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_ddlerp_and_decay_match_reference():
    jp, p = _layer()
    rng = np.random.default_rng(1)
    x, xx = (rng.standard_normal((B, 5, 64)).astype(np.float32) for _ in range(2))
    want = jrwkv6._ddlerp(jp, jnp.asarray(x), jnp.asarray(xx))
    got = rwkv6._ddlerp(p, torch.from_numpy(x), torch.from_numpy(xx))
    assert len(got) == len(want) == rwkv6.N_MIX
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    dec = rwkv6._decay(p, torch.from_numpy(x))
    np.testing.assert_allclose(_np(dec), _np(jrwkv6._decay(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    assert dec.dtype == torch.float32 and bool(((dec > 0) & (dec < 1)).all())


@pytest.mark.parametrize("S", [1, 37, 512], ids=["decode", "scan", "chunked"])
def test_wkv_scan_matches_reference(S):
    """S 512 takes the reference's chunked (rematerialised) branch."""
    H, N = 2, 8
    rng = np.random.default_rng(S)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, S, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    jy, js = jrwkv6._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    state = torch.from_numpy(s0.copy())
    y, s = rwkv6._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)), state)
    assert s is state                                      # advanced in place
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-5, atol=1e-4)


def test_time_mix_group_norm_uses_population_variance():
    """The per-head group norm divides by N (``jnp.var``), not N - 1."""
    jp, p = _layer()
    cfg = reduce_config(ARCH)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((B, 5, 4, 16)).astype(np.float32) * 3 + 1
    got = rwkv6._group_norm(cfg, p, torch.from_numpy(y))
    mu, var = y.mean(-1, keepdims=True), y.var(-1, keepdims=True)          # ddof 0
    want = ((y - mu) / np.sqrt(var + 64e-5)).reshape(B, 5, 64) * np.asarray(jp["ln_x_s"]) \
        + np.asarray(jp["ln_x_b"])
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    # and the whole time mix, whose output and state go through it
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    shift = rng.standard_normal((B, 64)).astype(np.float32)
    s0 = rng.standard_normal((B, 4, 16, 16)).astype(np.float32) * 0.1
    jcfg = jreduce_config(ARCH)
    jo, jshift, jstate = jrwkv6._time_mix(jcfg, jp, *(jnp.asarray(a) for a in (x, shift, s0)))
    o, sh, st = rwkv6._time_mix(cfg, p, *(torch.from_numpy(a.copy()) for a in (x, shift, s0)))
    for a, b in ((o, jo), (sh, jshift), (st, jstate)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x, sc, b = (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
                for shape in ((3, 5, 64), (64,), (64,)))
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in (x, sc, b)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, sc, b)]
    got, want = cm.layernorm(*tt, 1e-5), jcm.layernorm(*jt, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """The reference's float32-mode shifts start in bf16: it is handed
    them in f32, the port's dtype from the start (ROADMAP §3)."""
    jmodel, jparams, model, params = _models(dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    steps = rng.integers(1, 512, size=(N_DECODE, B)).astype(np.int32)
    act = getattr(jnp, dtype)
    jcache = {k: v.astype(act) if k.endswith("shift") else v
              for k, v in jmodel.init_cache(B, 16).items()}
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt), jcache)
    cache = model.init_cache(B, 16)
    logits, cache = model.prefill(params, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=LOGIT_TOL[dtype],
                               rtol=LOGIT_TOL[dtype])
    jdecode = jax.jit(jmodel.decode_step)
    for tok in steps:
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=LOGIT_TOL[dtype],
                                   rtol=LOGIT_TOL[dtype])
    assert set(cache) == set(jcache)
    for k in cache:
        assert str(cache[k].dtype).split(".")[-1] == str(jcache[k].dtype), k
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]), err_msg=k, **CACHE_TOL[dtype])
    assert cache["lengths"].tolist() == [S0 + N_DECODE] * B


def test_prefill_decode_consistency():
    """As ``tests/test_models.py`` holds the reference: a prefill of S + 1
    tokens gives the logits of a prefill of S then one decode step."""
    cfg = reduce_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, 13)))
    log_a, _ = model.prefill(params, toks, model.init_cache(B, 32))
    cache = model.init_cache(B, 32)
    model.prefill(params, toks[:, :12], cache)
    log_b, cache = model.decode_step(params, cache, toks[:, 12])
    scale = float(log_a.float().abs().max())
    assert float((log_a.float() - log_b.float()).abs().max()) <= 2.5e-2 * scale + 1e-5
    assert cache["lengths"].tolist() == [13] * B
