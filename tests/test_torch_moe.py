"""The port's MoE family against the JAX package with the same weights and
inputs (made with numpy or by ``repro``, carried across as numpy), on
reduced moonshot-v1-16b-a3b: the router, the dropping dispatch and
combine, ``moe_ffn``, prefill and decode; the parameter tree through the
bridge; the ``small`` / ``ones`` inits and the slab-wise draw of large
leaves; and the interpret-mode Pallas decode and flash kernels against the
port's plain versions at moonshot's head shape (one query head per KV
head, 128-wide heads).

Tolerances: router weights 1e-6 (f32 sigmoid/softmax in two frameworks);
the dispatch buffers and the combine bit for bit (the same copies, and the
same K adds per token in the same order, each rounded to the dtype); the
FFN and logits 1e-4 in float32 mode (f32 sums in other orders), the FFN
2e-2 and logits 0.1 in bf16 mode (both frameworks round activations to
bf16 at slightly different places; the logits are O(1)); the cache below
``lengths`` to one bf16 ulp (2**-7 relative) in float32 mode and, in bf16
mode, 0.1 absolute plus 2**-4 relative (the K/V after an MoE layer come
out of activations rounded at other places: one value in 4224 is 5% off
at seed 0); kernels as
``tests/test_torch_kernels.py`` (f32 1e-5, bf16 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.kernels import ops as jops
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model

ARCH = "moonshot-v1-16b-a3b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
FFN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": dict(rtol=2**-7, atol=1e-6), "bfloat16": dict(rtol=2**-4, atol=1e-1)}


def _cfgs(dtype="float32", **moe_kw):
    jcfg = jreduce_config(ARCH).with_overrides(dtype=dtype)
    cfg = reduce_config(ARCH).with_overrides(dtype=dtype)
    if moe_kw:
        jcfg = jcfg.with_overrides(moe=jcfg.moe.__class__(**{**jcfg.moe.__dict__, **moe_kw}))
        cfg = cfg.with_overrides(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, **moe_kw}))
    return jcfg, cfg


def _layer(jparams, dtype):
    """Layer 0 of the reference's MoE blocks: (jax tree, torch tree)."""
    jp = {k: v[0] for k, v in jparams["moe_blocks"].items()}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _x(T, D, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def test_config_matches_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_config(ARCH), jreduce_config(ARCH))):
        assert cfg.moe.__dict__ == jcfg.moe.__dict__
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                  "head_dim", "rope_theta", "norm_eps", "tie_embeddings", "dtype"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
    full = build_model(get_config(ARCH), "cpu")
    jfull = jbuild_model(jget_config(ARCH), Env())
    assert full.n_params() == jfull.n_params() == 28386592768
    assert jax.tree.map(lambda d: d.shape, full.param_defs, is_leaf=jcm.is_def) == \
        jax.tree.map(lambda d: d.shape, jfull.param_defs, is_leaf=jcm.is_def)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("score_func", ["sigmoid", "softmax"])
def test_router_scores_match_reference(score_func, x_dtype):
    jcfg, cfg = _cfgs(score_func=score_func)
    jparams = jbuild_model(jcfg, Env()).init(jax.random.key(1))
    jp, p = _layer(jparams, "float32")
    jx, x = _x(64, cfg.d_model, x_dtype)
    jw, ji, _ = jmoe.router_scores(jcfg, jp["router"], jx)
    w, i = moe.router_scores(cfg, p["router"], x)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


def test_top_k_order_on_ties():
    """``lax.top_k``'s order: descending, ties to the lower expert id."""
    jcfg, cfg = _cfgs(score_func="softmax")
    x = torch.zeros(3, cfg.d_model)
    x[1, 0] = 1.0
    router = torch.zeros(cfg.d_model, cfg.moe.n_experts)
    router[0, 5] = router[0, 6] = 2.0
    _, ji, _ = jmoe.router_scores(jcfg, jnp.asarray(router.numpy()), jnp.asarray(x.numpy()))
    _, i = moe.router_scores(cfg, router, x)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i[0].tolist() == [0, 1] and i[1].tolist() == [5, 6]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_drop_like_reference(dtype):
    """64 tokens, top-2 of 8 experts at capacity factor 0.5: 8 rows per
    expert for 128 assignments, so tokens drop.  The drop set and rows
    equal the reference's, the buffers below the garbage row and the
    combined output bit for bit."""
    jcfg, cfg = _cfgs(dtype, capacity_factor=0.5)
    jparams = jbuild_model(jcfg, Env()).init(jax.random.key(2))
    jp, p = _layer(jparams, dtype)
    T, D = 64, cfg.d_model
    jx, x = _x(T, D, dtype, seed=3)
    jdisp, (je, jpos, jdrop, jtok, jw), _ = jmoe._moe_dispatch_local(jcfg, jp, jx)
    w, topi = moe.router_scores(cfg, p["router"], x)
    disp, (e, pos, drop) = moe.dispatch(cfg, x, topi)
    cap = moe.capacity(cfg, T)
    assert cap == 8 and disp.shape == (8, cap + 1, D) and disp.dtype == x.dtype
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    assert 0 < int(drop.sum()) < T * cfg.moe.top_k
    np.testing.assert_array_equal(_np(disp[:, :cap]), _np(jdisp[:, :cap]))

    out = np.random.default_rng(4).standard_normal(disp.shape).astype(np.float32)
    jout, tout = jnp.asarray(out, getattr(jnp, dtype)), torch.from_numpy(out).to(x.dtype)
    jy = jmoe._moe_combine_local(jcfg, jout, (je, jpos, jdrop, jtok, jw), T, D)
    y = moe.combine(tout, (e, pos, drop), torch.from_numpy(np.array(jw)))
    assert y.dtype == x.dtype
    np.testing.assert_array_equal(_np(y), _np(jy))
    # a token whose choices all dropped gets exactly 0
    gone = drop.view(T, -1).all(-1)
    assert torch.equal(y[gone], torch.zeros_like(y[gone]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 16, 64])
def test_moe_ffn_matches_reference(T, dtype):
    jcfg, cfg = _cfgs(dtype)
    jparams = jbuild_model(jcfg, Env()).init(jax.random.key(5))
    jp, p = _layer(jparams, dtype)
    jx, x = _x(T, cfg.d_model, dtype, seed=T)
    jy, _ = jmoe.moe_ffn(jcfg, Env(), jp, jx)
    y = moe.moe_ffn(cfg, p, x)
    assert y.dtype == x.dtype and y.shape == x.shape
    tol = FFN_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(jy), atol=tol, rtol=tol)


def _models(dtype):
    jcfg, cfg = _cfgs(dtype)
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    jmodel, jparams, model, params = _models(dtype)
    B, S0, max_seq, tol = 2, 7, 16, LOGIT_TOL[dtype]
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, max_seq))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, max_seq))
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(4):
        tok = rng.integers(1, 512, size=(B,)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol,
                                   err_msg=f"decode step {t}")
    n = S0 + 4
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key][:, :, :n]), _np(jcache[key][:, :, :n]),
                                   **CACHE_TOL[dtype])


def test_model_has_only_the_reference_steps():
    model = build_model(reduce_config(ARCH), "cpu")
    jmodel = jbuild_model(jreduce_config(ARCH), Env())
    for name in ("decode_sample_step", "prefill_step", "prefill_sample_step",
                 "paged_cache_defs", "init_paged_cache", "paged_decode_step",
                 "paged_decode_sample_step", "verify_step", "paged_verify_step"):
        assert getattr(model, name) is None and getattr(jmodel, name) is None, name


def test_params_from_numpy_carries_the_moe_tree():
    jmodel = jbuild_model(jreduce_config(ARCH), Env())
    jparams = jmodel.init(jax.random.key(6))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ref_tree = build_model(reduce_config(ARCH), "cpu").init(0)
    assert set(params) == set(jparams) == set(ref_tree) == \
        {"embed", "unembed", "dense_blocks", "moe_blocks", "final_norm"}
    for group in ("dense_blocks", "moe_blocks"):
        assert set(params[group]) == set(jparams[group]) == set(ref_tree[group])
        for k, t in params[group].items():
            assert t.dtype == torch.bfloat16 and t.shape == ref_tree[group][k].shape, k
            np.testing.assert_array_equal(_np(t), _np(jparams[group][k]))


def test_small_and_ones_inits():
    defs = {"r": cm.ParamDef((64, 4096), ("embed", None), "small"),
            "o": cm.ParamDef((3, 5), ("layers", "embed"), "ones"),
            "z": cm.ParamDef((2,), ("embed",), "zeros")}
    out = cm.init_params(defs, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert abs(float(out["r"].std()) - 1e-4) < 2e-6
    assert torch.equal(out["o"], torch.ones(3, 5)) and torch.equal(out["z"], torch.zeros(2))
    jout = jcm.init_params(defs, jax.random.key(0), jnp.float32)
    assert abs(float(jnp.std(jout["r"])) - 1e-4) < 2e-6
    np.testing.assert_array_equal(np.asarray(jout["o"]), out["o"].numpy())


def test_init_params_draws_whole_leaves_as_before(monkeypatch):
    """Every leaf of llama3.2-1b at full width is at most ``SLAB_ELEMENTS``,
    so it is drawn whole, as before slab-wise draws existed (one f32
    normal per leaf in sorted-key order, scaled and cast): the weights
    from a seed, and every earlier path's tokens, stay as they were.
    moonshot's three expert stacks are the leaves drawn by slabs; a slab
    draw takes the leaf's slabs in order from the same generator."""
    def old_init(tree, gen, dtype):
        out = {}
        for path, d in cm._leaves(tree):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = (torch.zeros(d.shape, dtype=dtype) if d.init == "zeros" else
                              torch.randn(d.shape, generator=gen, dtype=torch.float32)
                              .mul_(cm._std(d)).to(dtype))
        return out

    llama = build_model(get_config("llama3.2-1b"), "cpu")
    assert all(np.prod(d.shape) <= cm.SLAB_ELEMENTS for _, d in cm._leaves(llama.param_defs))
    big = [path for path, d in cm._leaves(build_model(get_config(ARCH), "cpu").param_defs)
           if np.prod(d.shape) > cm.SLAB_ELEMENTS]
    assert big == [("moe_blocks", k) for k in ("we_down", "we_gate", "we_up")]
    small = build_model(reduce_config("llama3.2-1b"), "cpu")
    new, old = small.init(0), old_init(small.param_defs, torch.Generator().manual_seed(0),
                                       torch.bfloat16)
    for path, _ in cm._leaves(small.param_defs):
        a, b = new, old
        for key in path:
            a, b = a[key], b[key]
        assert torch.equal(a, b), path

    monkeypatch.setattr(cm, "SLAB_ELEMENTS", 100)
    defs = {"w": cm.ParamDef((3, 8, 16), ("layers", "embed", "mlp"))}
    got = cm.init_params(defs, torch.Generator().manual_seed(1), torch.bfloat16, "cpu")["w"]
    gen = torch.Generator().manual_seed(1)
    want = torch.stack([torch.randn(8, 16, generator=gen).mul_(8 ** -0.5).to(torch.bfloat16)
                        for _ in range(3)])
    assert torch.equal(got, want)


# ----------------------------------- kernels at moonshot's head shape (G 1, D 128)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_at_moe_heads_matches_interpret_mode_pallas(dtype):
    B, S, Hkv, D = 2, 64, 2, 128
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Hkv, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    lengths = np.array([37, 64], np.int32)
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    want = jops.decode_attention(*jt, jnp.asarray(lengths), block_s=16)
    got = ops.decode_attention(*tt, torch.from_numpy(lengths))
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_moe_heads_matches_interpret_mode_pallas(dtype):
    B, S, H, D = 1, 48, 2, 128
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal((B, S, H, D), np.float32) for _ in range(3)]
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = jops.flash_attention(*jt, causal=True, block_q=16, block_k=16)
    got = ops.flash_attention(*tt, causal=True)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
