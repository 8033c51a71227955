"""The port's Zamba2 family (mamba2 backbone + one shared attention block)
against the JAX package with the same weights and inputs (made with numpy
or by ``repro``, carried across as numpy), on reduced zamba2-1.2b (5
mamba2 layers, a shared block after layers 1 and 3, d 64, 4 heads of 32 in
the block, SSM heads of 8 and state 8): the config and parameter tree, the
SSD recurrence on both of the reference's branches, one mamba2 layer with
a carried conv state, the shared block's q/k/v with the per-slot LoRA and
both shared blocks (prefill and decode, with a write at a full cache), and
a prefill followed by decode steps, logits and every cache leaf.

Tolerances: f32 pieces 1e-5 (sums in other orders); the blocks 1e-4;
logits 1e-4 in float32 mode and 0.1 in bf16, as
``tests/test_torch_dense.py`` holds the dense family's; the cache in
float32 mode one bf16 ulp (the K/V cache is bf16; the states f32), in bf16
0.1 absolute plus 2**-4 relative.
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
from repro.models import mamba2 as jmamba2
from repro.models import zamba2 as jzamba2
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import common as cm
from repro_torch.models import mamba2, zamba2
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model

ARCH = "zamba2-1.2b"
B, S0, N_DECODE = 2, 7, 3
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": dict(rtol=2**-7, atol=1e-5), "bfloat16": dict(rtol=2**-4, atol=1e-1)}
N_PARAMS = 1322652544


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(dtype, scaled: bool = True):
    """Seed-0 weights in both frameworks; ``scaled``: the "small" conv and
    LoRA-A weights scaled up and the zero LoRA-B drawn, so that their terms
    matter (at the seed's conv weights, std 1e-4, the SSM path carries
    almost nothing)."""
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype=dtype), Env())
    jparams = jmodel.init(jax.random.key(0))
    if scaled:
        sh = jparams["shared"]
        jparams["mamba"]["conv_w"] = jparams["mamba"]["conv_w"] * 3000
        sh["lora_a"] = sh["lora_a"] * 3000
        sh["lora_b"] = 0.1 * jax.random.normal(jax.random.key(5), sh["lora_b"].shape,
                                               sh["lora_b"].dtype)
    model = build_model(reduce_config(ARCH).with_overrides(dtype=dtype), "cpu")
    return jmodel, jparams, model, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_config_and_params_match_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_config(ARCH), jreduce_config(ARCH))):
        assert cfg.ssm.__dict__ == jcfg.ssm.__dict__
        assert cfg.hybrid.__dict__ == jcfg.hybrid.__dict__
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "norm_eps", "dtype", "subquadratic"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert zamba2._slots(cfg) == jzamba2._slots(jcfg)
        assert zamba2._segments(cfg) == jzamba2._segments(jcfg)
        assert zamba2._attn_dims(cfg) == jzamba2._attn_dims(jcfg)
        assert mamba2.dims(cfg) == jmamba2.dims(jcfg)
        shapes = jax.tree.map(lambda d: d.shape, jzamba2.param_defs(jcfg), is_leaf=jcm.is_def)
        mine = jax.tree.map(lambda d: d.shape, zamba2.param_defs(cfg),
                            is_leaf=lambda d: isinstance(d, cm.ParamDef))
        assert mine == shapes
    full = get_config(ARCH)
    # the shared block's heads: 2 * d_model / n_heads = 128 wide, G 1
    assert zamba2._attn_dims(full) == (4096, 32, 128) and full.n_kv_heads == 32
    assert zamba2._slots(full) == [5, 11, 17, 23, 29, 35]
    assert build_model(full, "cpu").n_params() == N_PARAMS


@pytest.mark.parametrize("S", [1, 37, 512], ids=["decode", "scan", "chunked"])
def test_ssd_scan_matches_reference(S):
    """S 512 takes the reference's chunked (rematerialised) branch."""
    H, P, N = 3, 4, 8
    rng = np.random.default_rng(S)
    xp = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.0, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, (H,)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, js = jmamba2._ssd_scan(*(jnp.asarray(a) for a in (xp, Bm, Cm, dt, A, s0)))
    state = torch.from_numpy(s0.copy())
    y, s = mamba2._ssd_scan(*(torch.from_numpy(a) for a in (xp, Bm, Cm, dt, A)), state)
    assert s is state                                      # advanced in place
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("S", [1, 6])
def test_mamba2_forward_with_carried_conv_state(S):
    jmodel, jparams, model, params = _models("float32")
    cfg, jcfg = model.cfg, jmodel.cfg
    jp = jax.tree.map(lambda a: a[1], jparams["mamba"])
    p = {k: v[1] for k, v in params["mamba"].items()}
    _, H, conv_dim, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm.d_conv - 1, conv_dim)).astype(np.float32)
    ssm = rng.standard_normal((B, H, cfg.ssm.d_head, cfg.ssm.d_state)).astype(np.float32) * 0.1
    want = jmamba2.forward(jcfg, jp, *(jnp.asarray(a) for a in (x, conv, ssm)))
    got = mamba2.forward(cfg, p, *(torch.from_numpy(a.copy()) for a in (x, conv, ssm)))
    for a, b, name in zip(got, want, ("out", "conv", "ssm")):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_shared_blocks_match_reference():
    jmodel, jparams, model, params = _models("float32")
    cfg, jcfg = model.cfg, jmodel.cfg
    jp, p = jparams["shared"], params["shared"]
    D2, H, Dh = zamba2._attn_dims(cfg)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, 5, D2)).astype(np.float32)
    for slot in range(len(zamba2._slots(cfg))):
        for a, b in zip(zamba2._shared_qkv(cfg, p, slot, torch.from_numpy(h)),
                        jzamba2._shared_qkv(jcfg, jp, slot, jnp.asarray(h))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    # prefill
    x, x0 = (rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (B, 5))
    want = jzamba2._shared_block_train(jcfg, Env(), jp, 1, jnp.asarray(x), jnp.asarray(x0),
                                       jnp.asarray(pos))
    got = zamba2._shared_block_train(cfg, p, 1, torch.from_numpy(x), torch.from_numpy(x0),
                                       torch.from_numpy(pos.copy()))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)
    # decode: row 1's cache is full (the reference drops its write, the port skips it)
    S = 8
    k0, v0 = (rng.standard_normal((B, S, H, Dh)).astype(np.float32) for _ in range(2))
    lengths = np.array([3, S], np.int32)
    x, x0 = (rng.standard_normal((B, cfg.d_model)).astype(np.float32) for _ in range(2))
    jd, jk, jv = jzamba2._shared_block_decode(jcfg, Env(), jp, 0, jnp.asarray(x),
                                              jnp.asarray(x0), jnp.asarray(k0),
                                              jnp.asarray(v0), jnp.asarray(lengths))
    kc, vc = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = torch.from_numpy(lengths)
    pos_t = tl.long()
    d = zamba2._shared_block_decode(cfg, p, 0, torch.from_numpy(x), torch.from_numpy(x0), kc, vc,
                                    pos_t, pos_t.clamp(max=S - 1), pos_t < S, tl + 1)
    np.testing.assert_allclose(_np(d), _np(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(kc), _np(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(vc), _np(jv), rtol=1e-5, atol=1e-5)
    assert torch.equal(kc[1], torch.from_numpy(k0[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """The reference's float32-mode conv state starts in bf16: it is handed
    it in f32, the port's dtype from the start (ROADMAP §3).  bf16 at the
    seed's weights: with the scaled conv each mamba2 layer's output is
    O(3) and differs by ~1.4% from bf16 rounding at other places, which the
    random layers compound past the 0.1 tolerance; float32 mode at the
    scaled weights holds every term to 1e-4."""
    jmodel, jparams, model, params = _models(dtype, scaled=dtype == "float32")
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    steps = rng.integers(1, 512, size=(N_DECODE, B)).astype(np.int32)
    jcache = {k: v.astype(getattr(jnp, dtype)) if k == "conv" else v
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
