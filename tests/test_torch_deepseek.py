"""The port's DeepSeek family against the JAX package with the same weights
and inputs (made with numpy or by ``repro``, carried across as numpy), on
reduced deepseek-v3-671b (3 layers, the first dense, 8 experts top-2, MLA
ranks 48/32, heads 16 + 8 rope / v 16): the configs, the parameter tree
and its counts, the absorbed MLA decode, prefill and decode steps, the
cost model's branches, and the nested slab-wise draw that keeps the load
of a full-width expert stack inside one f32 slab.

Tolerances: the MLA decode 1e-5 in f32 and 2e-2 in bf16 (as the kernels
are held, ``tests/test_torch_kernels.py``); the MLA identity (absorbed ==
expanded) 3e-5 in f32, as ``tests/test_attention.py`` holds the
reference's; logits and the latent cache as ``tests/test_torch_moe.py``
holds moonshot's (logits 1e-4 in float32 mode and 0.1 in bf16; the cache
to one bf16 ulp in float32 mode, 0.1 absolute plus 2**-4 relative in
bf16, where both frameworks round activations at other places).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core import balance as jbalance
from repro.core.placement import Env
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models.registry import build_model as jbuild_model
from repro_torch.analysis import roofline
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import balance, offload
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import deepseek
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache

ARCH = "deepseek-v3-671b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": dict(rtol=2**-7, atol=1e-6), "bfloat16": dict(rtol=2**-4, atol=1e-1)}
MLA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
N_PARAMS = 671712669696          # 61 layers
N_PARAMS_5 = 27304652800         # the 5 layers the card holds: 3 dense + 2 MoE


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _shapes(defs):
    return jax.tree.map(lambda d: d.shape, defs, is_leaf=jcm.is_def)


def test_config_matches_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_config(ARCH), jreduce_config(ARCH))):
        assert cfg.moe.__dict__ == jcfg.moe.__dict__
        assert cfg.mla.__dict__ == jcfg.mla.__dict__
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "norm_eps", "tie_embeddings",
                  "mtp_depth", "dtype", "kv_quant", "frontend", "frontend_len"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
    red = reduce_config(ARCH)
    assert (red.n_layers, red.moe.moe_layer_start, red.moe.n_experts, red.moe.top_k) == \
        (3, 1, 8, 2)


def _both(which):
    """(port config, reference config): full width at 61 or 5 layers, or
    reduced."""
    if which == "reduced":
        return reduce_config(ARCH), jreduce_config(ARCH)
    over = dict(n_layers=5) if which == "5 layers" else {}
    return get_config(ARCH).with_overrides(**over), jget_config(ARCH).with_overrides(**over)


@pytest.mark.parametrize("which,want", [("full", N_PARAMS), ("5 layers", N_PARAMS_5),
                                        ("reduced", None)])
def test_param_defs_and_counts_match_reference(which, want):
    cfg, jcfg = _both(which)
    model, jmodel = build_model(cfg, "cpu"), jbuild_model(jcfg, Env())
    assert model.n_params() == jmodel.n_params() == (want or jmodel.n_params())
    assert _shapes(model.param_defs) == _shapes(jmodel.param_defs)
    assert _shapes(model.cache_defs(4, 64)) == _shapes(jmodel.cache_defs(4, 64))
    assert set(model.param_defs) == {"embed", "dense_blocks", "moe_blocks", "final_norm",
                                     "unembed", "mtp"}


def _mla_inputs(dtype, B=4, S=24, H=3, Dc=32, Dr=8, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, np.float32)
              for s in ((B, H, Dc), (B, H, Dr), (B, S, Dc), (B, S, Dr))]
    lengths = np.array([1, S, 7, 13][:B], np.int32)
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jt, tt, lengths


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_attention_matches_reference(dtype, cache_dtype):
    """Queries in ``dtype`` over a cache in ``cache_dtype`` (float32 mode
    keeps a bf16 cache), lengths 1, S and between."""
    jt, tt, lengths = _mla_inputs(dtype)
    for i in (2, 3):
        jt[i] = jt[i].astype(getattr(jnp, cache_dtype))
        tt[i] = tt[i].to(getattr(torch, cache_dtype))
    scale = 1.0 / math.sqrt(40)
    want = jattn.mla_decode_attention(*jt, jnp.asarray(lengths), scale=scale)
    got = offload.mla_decode_attention(*tt, torch.from_numpy(lengths), scale=scale)
    assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
    tol = MLA_TOL[dtype if cache_dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_absorbed_decode_equals_expanded():
    """The MLA identity in the port: attending over the latent with W_UK
    absorbed into the query, then applying W_UV, equals expanding K and V
    per head and attending (f32, 3e-5, as the reference's test)."""
    B, S, H, Dc, Dr, Dn = 2, 12, 3, 16, 4, 8
    g = torch.Generator().manual_seed(3)
    ckv, krope = torch.randn(B, S, Dc, generator=g), torch.randn(B, S, Dr, generator=g)
    q_nope, q_rope = torch.randn(B, H, Dn, generator=g), torch.randn(B, H, Dr, generator=g)
    w_uk, w_uv = torch.randn(Dc, H, Dn, generator=g), torch.randn(Dc, H, Dn, generator=g)
    scale = 1.0 / math.sqrt(Dn + Dr)
    lengths = torch.tensor([S, 5], dtype=torch.int32)
    kf = torch.cat([torch.einsum("bsr,rhk->bshk", ckv, w_uk),
                    krope[:, :, None].expand(B, S, H, Dr)], -1)
    vf = torch.einsum("bsr,rhk->bshk", ckv, w_uv)
    qf = torch.cat([q_nope, q_rope], -1)
    expected = attn.decode_attention(qf, kf, vf, lengths, scale=scale)
    lat = attn.mla_decode_attention(torch.einsum("bhn,rhn->bhr", q_nope, w_uk), q_rope, ckv,
                                    krope, lengths, scale=scale)
    got = torch.einsum("bhr,rhn->bhn", lat, w_uv)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), atol=3e-5, rtol=3e-5)


def _models(dtype):
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype=dtype), Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(ARCH).with_overrides(dtype=dtype), "cpu")
    return jmodel, jparams, model, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("S0,max_seq", [(7, 16), (14, 16)], ids=["inside", "past-max-seq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype, S0, max_seq):
    """A prefill, then three decode steps: logits, lengths and the latent
    cache.  From 14 of 16 positions the last step writes past ``max_seq``,
    which JAX drops and the port skips."""
    jmodel, jparams, model, params = _models(dtype)
    B, tol = 2, LOGIT_TOL[dtype]
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, max_seq))
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  model.init_cache(B, max_seq))
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(3):
        tok = rng.integers(1, 512, size=(B,)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol, rtol=tol,
                                   err_msg=f"decode step {t}")
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    assert cache["ckv"].dtype == cache["krope"].dtype == torch.bfloat16
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **CACHE_TOL[dtype])


def test_prefill_writes_a_slot_view_and_ignores_embeds():
    """Prefill into one slot's view of a 3-slot cache writes only that
    slot; ``embeds`` changes nothing, as in the reference."""
    _, _, model, params = _models("float32")
    prompt = torch.arange(1, 10)[None]
    cache = model.init_cache(3, 16)
    logits, _ = model.prefill(params, prompt, kv_cache.slot_view(cache, 1))
    alone = model.init_cache(1, 16)
    logits2, _ = model.prefill(params, prompt, alone,
                               embeds=torch.ones(1, 4, model.cfg.d_model))
    assert torch.equal(logits, logits2)
    assert cache["lengths"].tolist() == [0, 9, 0]
    for key in ("ckv", "krope"):
        assert torch.equal(cache[key][:, 1:2], alone[key])
        assert not cache[key][:, 0].any() and not cache[key][:, 2].any()


@pytest.mark.parametrize("which", ["reduced", "full", "5 layers"])
def test_cost_model_matches_reference(which):
    cfg, jcfg = _both(which)
    assert balance._active_params(cfg) == jbalance._active_params(jcfg)
    for seq in (1, 1000, 8115):
        assert balance.kv_bytes_per_seq(cfg, seq) == jbalance.kv_bytes_per_seq(jcfg, seq)
    for args in [(16, 8115), (0, 0, 509, 129795), (3, 700, 32, 6656, 1e6), (1, 1)]:
        assert roofline.dispatch_flops_bytes(cfg, *args) == \
            jroofline.dispatch_flops_bytes(jcfg, *args)


def test_model_has_only_the_reference_steps():
    model = build_model(reduce_config(ARCH), "cpu")
    jmodel = jbuild_model(jreduce_config(ARCH), Env())
    for name in ("decode_sample_step", "prefill_step", "prefill_sample_step",
                 "paged_cache_defs", "init_paged_cache", "paged_decode_step",
                 "paged_decode_sample_step", "verify_step", "paged_verify_step"):
        assert getattr(model, name) is None and getattr(jmodel, name) is None, name


def test_params_from_numpy_carries_the_deepseek_tree():
    jparams = jbuild_model(jreduce_config(ARCH), Env()).init(jax.random.key(6))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ours = build_model(reduce_config(ARCH), "cpu").init(0)
    flat = jax.tree_util.tree_flatten_with_path
    jleaves, tleaves = flat(jparams)[0], flat(params)[0]
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves] == [p for p, _ in flat(ours)[0]]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(t), _np(j))
    assert set(params["mtp"]) == {"norm_h", "norm_e", "proj", "block", "final_norm"}


def test_init_params_fills_nested_slabs_in_place(monkeypatch):
    """A leaf whose leading-axis slab still exceeds ``SLAB_ELEMENTS`` (one
    layer of deepseek-v3-671b's expert stacks: 256 x 7168 x 2048) is drawn
    one slab of the slab's own leading axis at a time, in order, into the
    destination: the draws are those of the innermost slabs taken one after
    another from the generator.  At full width deepseek's three stacks are
    the only such leaves, and their innermost slabs are one expert's
    matrix."""
    monkeypatch.setattr(cm, "SLAB_ELEMENTS", 100)
    defs = {"w": cm.ParamDef((2, 3, 8, 16), ("layers", "experts", "embed", "mlp"))}
    got = cm.init_params(defs, torch.Generator().manual_seed(1), torch.bfloat16, "cpu")["w"]
    gen = torch.Generator().manual_seed(1)
    want = torch.stack([torch.stack([
        torch.stack([torch.randn(16, generator=gen).mul_(8 ** -0.5).to(torch.bfloat16)
                     for _ in range(8)]) for _ in range(3)]) for _ in range(2)])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    monkeypatch.undo()

    full = build_model(get_config(ARCH).with_overrides(n_layers=5), "cpu").param_defs
    nested = [path for path, d in cm._leaves(full)
              if np.prod(d.shape[1:]) > cm.SLAB_ELEMENTS]
    assert nested == [("moe_blocks", k) for k in ("we_down", "we_gate", "we_up")]
    assert all(np.prod(full["moe_blocks"][k].shape[2:]) <= cm.SLAB_ELEMENTS
               for k in ("we_down", "we_gate", "we_up"))


def test_mla_layer_functions_write_the_latent_cache():
    """``_mla_decode_attn`` appends one latent and rope key per row at
    ``wpos`` where ``valid`` and leaves a row past the end as it was."""
    _, _, model, params = _models("float32")
    cfg = model.cfg
    p = {k: v[0] for k, v in params["dense_blocks"].items()}
    B, S = 2, 8
    ckv = torch.zeros(B, S, cfg.mla.kv_lora_rank, dtype=torch.bfloat16)
    kr = torch.zeros(B, S, cfg.mla.qk_rope_head_dim, dtype=torch.bfloat16)
    x = torch.randn(B, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.tensor([3, S])
    out = deepseek._mla_decode_attn(cfg, p, x, ckv, kr, pos, pos.clamp(max=S - 1), pos < S,
                                    pos + 1)
    assert out.shape == (B, cfg.d_model) and torch.isfinite(out).all()
    assert ckv[0, 3].any() and kr[0, 3].any()
    assert not ckv[1].any() and not kr[1].any()
