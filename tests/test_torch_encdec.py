"""The port's encoder-decoder (seamless-m4t-medium's backbone) against the
JAX package with the same weights and inputs (made with numpy or by
``repro``, carried across as numpy), on reduced seamless-m4t-medium (2
encoder and 2 decoder layers, d 64, 4 heads of 16, 8 frames): the config
and parameter tree, ``encode``, a prefill over frame embeddings followed by
decode steps (logits and every cache leaf), the prefill without frames
(the reference's failure, model and serve CLI), and the decode and flash
kernels' plain versions at the family's heads (G 1, D 64; the cross
cache read whole by every row) against interpret-mode Pallas.

Tolerances: ``encode`` 1e-5 in f32; logits 1e-4 in float32 mode and 0.1
in bf16, as ``tests/test_torch_dense.py`` holds the dense family's; the
cache in float32 mode one bf16 ulp (the caches are bf16), in bf16 0.1
plus 2**-4 of the leaf's largest magnitude (its K/V reach ~17 here, where
a bf16 ulp is 0.0625 and activations rounded at other places move a value
by a few ulps); kernels 1e-5 / 2e-2 as ``tests/test_torch_kernels.py``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import common as jcm
from repro.models import encdec as jencdec
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import common as cm
from repro_torch.models import encdec
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model

ARCH = "seamless-m4t-medium"
B, S0, N_DECODE = 2, 7, 3
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": dict(rtol=2**-7, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=1e-1)}
N_PARAMS = 977860608


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(dtype):
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype=dtype), Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(ARCH).with_overrides(dtype=dtype), "cpu")
    return jmodel, jparams, model, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _frames(cfg, seed=2) -> np.ndarray:
    """Stub frame embeddings (B, frontend_len, d_model), bf16 values."""
    f = np.random.default_rng(seed).standard_normal((B, cfg.frontend_len, cfg.d_model))
    return np.array(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))


def test_config_and_params_match_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_config(ARCH), jreduce_config(ARCH))):
        for f in ("name", "family", "n_layers", "n_enc_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta", "norm_eps",
                  "frontend", "frontend_len", "dtype"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        shapes = jax.tree.map(lambda d: d.shape, jencdec.param_defs(jcfg), is_leaf=jcm.is_def)
        mine = jax.tree.map(lambda d: d.shape, encdec.param_defs(cfg),
                            is_leaf=lambda d: isinstance(d, cm.ParamDef))
        assert mine == shapes
        cache = jax.tree.map(lambda d: d.shape, jencdec.cache_defs(jcfg, 3, 40),
                             is_leaf=jcm.is_def)
        assert jax.tree.map(lambda d: d.shape, encdec.cache_defs(cfg, 3, 40),
                            is_leaf=lambda d: isinstance(d, cm.ParamDef)) == cache
    assert build_model(get_config(ARCH), "cpu").n_params() == N_PARAMS


def test_encode_matches_reference():
    jmodel, jparams, model, params = _models("float32")
    frames = _frames(model.cfg)
    want = jencdec.encode(jmodel.cfg, Env(), jparams, jnp.asarray(frames), remat=False)
    got = encdec.encode(model.cfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    jmodel, jparams, model, params = _models(dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    steps = rng.integers(1, 512, size=(N_DECODE, B)).astype(np.int32)
    frames = _frames(model.cfg)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, 16),
                                              embeds=jnp.asarray(frames, jnp.bfloat16))
    cache = model.init_cache(B, 16)
    logits, cache = model.prefill(params, torch.from_numpy(prompt), cache,
                                  embeds=torch.from_numpy(frames).bfloat16())
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
        want = _np(jcache[k])
        tol = dict(CACHE_TOL[dtype])
        if dtype == "bfloat16":
            tol["atol"] += 2**-4 * float(np.abs(want).max())
        np.testing.assert_allclose(_np(cache[k]), want, err_msg=k, **tol)
    assert cache["lengths"].tolist() == [S0 + N_DECODE] * B


def test_prefill_decode_consistency():
    """As ``tests/test_models.py`` holds the reference: a prefill of S + 1
    tokens gives the logits of a prefill of S then one decode step."""
    cfg = reduce_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    frames = torch.from_numpy(_frames(cfg)).bfloat16()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, 13)))
    log_a, _ = model.prefill(params, toks, model.init_cache(B, 32), embeds=frames)
    cache = model.init_cache(B, 32)
    model.prefill(params, toks[:, :12], cache, embeds=frames)
    log_b, cache = model.decode_step(params, cache, toks[:, 12])
    scale = float(log_a.float().abs().max())
    assert float((log_a.float() - log_b.float()).abs().max()) <= 2.5e-2 * scale + 1e-5
    assert cache["lengths"].tolist() == [13] * B


def test_prefill_without_frames_fails_as_reference(capsys, monkeypatch):
    jmodel, jparams, model, params = _models("float32")
    toks = np.ones((1, 4), np.int32)
    with pytest.raises(AssertionError) as theirs:
        jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_cache(1, 8))
    with pytest.raises(AssertionError) as mine:
        model.prefill(params, torch.from_numpy(toks), model.init_cache(1, 8))
    assert str(mine.value) == str(theirs.value) == "encdec prefill needs src_embeds"
    # the serve CLIs: the engine passes no frames, so both fail at the first admission
    flags = ["--arch", ARCH, "--reduced", "--requests", "2", "--slots", "2", "--max-seq", "32",
             "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    with pytest.raises(AssertionError) as theirs:
        jserve.main()
    with pytest.raises(AssertionError) as mine:
        serve.main([*flags, "--device", "cpu"])
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_encdec_heads_match_interpret_mode_pallas(dtype):
    """G 1, D 64: the decode over a cross cache every row reads whole, and
    the flash prefill over two rows (the decoder's self-attention)."""
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(7)
    Bk, S, H, D = 2, 48, 2, 64
    q = rng.standard_normal((Bk, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bk, S, H, D)).astype(np.float32) for _ in range(2))
    lengths = np.full((Bk,), S, np.int32)
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    want = jops.decode_attention(*jt, jnp.asarray(lengths), block_s=16)
    got = ops.decode_attention(*tt, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    arrays = [rng.standard_normal((Bk, 24, H, D)).astype(np.float32) for _ in range(3)]
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = jops.flash_attention(*jt, causal=True, block_q=8, block_k=8)
    got = ops.flash_attention(*tt, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
