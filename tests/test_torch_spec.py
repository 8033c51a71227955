"""Speculative decoding's model and sampler pieces in the port against the
JAX package: ``verify_step`` / ``paged_verify_step`` on reduced
llama3.2-1b in float32 mode (f32 weights and activations, bf16 KV) with
the same weights carried across as numpy, ``spec_verify_tokens`` greedy
on the same logits, rejection sampling by distribution (torch's RNG is
not ``jax.random``), and the paged kernel's argument checks at block
sizes over 64.

Tolerances: logits 1e-4 (float32 mode, as ``tests/test_torch_dense.py``);
K/V pools and lengths exactly (the new K/V are bf16 casts of f32 values
that agree to far below a bf16 ulp); the port's verify against T of its
own decode steps exactly (the same calls); distributions within 5 sigma
(6 in the hypothesis case), as ``tests/test_spec.py`` holds the
reference.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving import sampler as jsampler
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.kernels import ref
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.sampler import (SamplerConfig, _transformed, spec_draft_sample,
                                         spec_verify_tokens)

T = 3                                    # verify window: k = 2 drafts


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _dense_caches(jmodel, model, lengths, S, seed):
    """A dense cache of random bf16 K/V at ``lengths``, in both frameworks."""
    jcache = jmodel.init_cache(len(lengths), S)
    cache = model.init_cache(len(lengths), S)
    rng = np.random.default_rng(seed)
    for key in ("k", "v"):
        x = _bf16(rng.standard_normal(cache[key].shape, np.float32))
        jcache[key] = jnp.asarray(x, jnp.bfloat16)
        cache[key].copy_(torch.from_numpy(x))
    jcache["lengths"] = jnp.asarray(lengths, jnp.int32)
    cache["lengths"].copy_(torch.from_numpy(np.asarray(lengths, np.int32)))
    return jcache, cache


def test_verify_step_matches_reference(models):
    """Three slots: mid-cache, one window that overshoots ``max_seq`` (JAX
    drops those writes, the port masks them) and an empty slot.  Logits
    within 1e-4, K/V and lengths exactly the reference's, lengths as they
    came in; and the logits equal three of the port's own decode steps."""
    jmodel, jparams, model, params = models
    S, lengths = 16, [5, 15, 0]
    jcache, cache = _dense_caches(jmodel, model, lengths, S, seed=1)
    toks = np.random.default_rng(2).integers(1, model.cfg.vocab, (3, T)).astype(np.int32)
    jlogits, jnew = jax.jit(jmodel.verify_step)(jparams, jcache, jnp.asarray(toks))
    stepwise = _clone(cache)
    logits, cache = model.verify_step(params, cache, torch.from_numpy(toks))
    assert logits.shape == (3, T, model.cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4)
    assert cache["lengths"].tolist() == lengths == np.asarray(jnew["lengths"]).tolist()
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(cache[key]), _np(jnew[key]), err_msg=key)
    for t in range(T):
        lg, _ = model.decode_step(params, stepwise, torch.from_numpy(toks[:, t]))
        assert torch.equal(lg, logits[:, t]), t
    for key in ("k", "v"):
        assert torch.equal(stepwise[key], cache[key]), key


def _paged_caches(jmodel, model, tables, lengths, bs, N, seed):
    """A scrambled bf16 pool with garbage in null block 0, in both
    frameworks."""
    B, MB = tables.shape
    jcache = jmodel.init_paged_cache(B, N, bs, MB)
    cache = model.init_paged_cache(B, N, bs, MB)
    rng = np.random.default_rng(seed)
    for key, garbage in (("k", 50.0), ("v", -50.0)):
        x = _bf16(rng.standard_normal(cache[key].shape, np.float32))
        x[:, 0] = garbage
        jcache[key] = jnp.asarray(x, jnp.bfloat16)
        cache[key].copy_(torch.from_numpy(x))
    for key, x in (("block_tables", tables), ("lengths", np.asarray(lengths, np.int32))):
        jcache[key] = jnp.asarray(x.copy())
        cache[key].copy_(torch.from_numpy(x))
    return jcache, cache


def test_paged_verify_step_matches_reference(models):
    """Block 4, 3 blocks per row: slot 0 crosses a block edge inside the
    window, slot 1's window runs past its table (positions 12, 13 go to
    null block 0, never to its last live block), slot 2 is idle.  Logits
    within 1e-4; the pool, null block included, and lengths exactly the
    reference's; no live block but the ones the windows address changed."""
    jmodel, jparams, model, params = models
    bs, N = 4, 10
    tables = np.array([[3, 7, 0], [5, 2, 9], [0, 0, 0]], np.int32)
    lengths = [3, 11, 0]
    jcache, cache = _paged_caches(jmodel, model, tables, lengths, bs, N, seed=3)
    before = _clone(cache)
    toks = np.random.default_rng(4).integers(1, model.cfg.vocab, (3, T)).astype(np.int32)
    jlogits, jnew = jax.jit(jmodel.paged_verify_step)(jparams, jcache, jnp.asarray(toks))
    logits, cache = model.paged_verify_step(params, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits[:2]), _np(jlogits[:2]), atol=1e-4, rtol=1e-4)
    assert cache["lengths"].tolist() == lengths == np.asarray(jnew["lengths"]).tolist()
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(cache[key]), _np(jnew[key]), err_msg=key)
        changed = {int(b) for b in torch.nonzero(
            (cache[key] != before[key]).flatten(2).any(-1).any(0)).flatten()}
        assert changed == {0, 3, 7, 9}, (key, changed)   # 9: slot 1's position 11
        assert torch.equal(cache[key][:, 5, :, :], before[key][:, 5, :, :])


def test_paged_verify_equals_decode_steps_inside_the_table(models):
    """Inside the table the paged verify is T of the port's own paged
    decode steps, bit for bit."""
    _, _, model, params = models
    bs, N = 4, 10
    tables = np.array([[3, 7, 1], [5, 2, 9]], np.int32)
    jmodel = models[0]
    _, cache = _paged_caches(jmodel, model, tables, [2, 6], bs, N, seed=5)
    stepwise = _clone(cache)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, model.cfg.vocab, (2, T)).astype(np.int32))
    logits, cache = model.paged_verify_step(params, cache, toks)
    for t in range(T):
        lg, _ = model.paged_decode_step(params, stepwise, toks[:, t])
        assert torch.equal(lg, logits[:, t]), t
    for key in ("k", "v"):
        assert torch.equal(stepwise[key], cache[key]), key
    assert cache["lengths"].tolist() == [2, 6]


def test_paged_verify_refuses_quantized_pools_and_the_host_tier(models):
    _, _, model, params = models
    toks = torch.ones(2, T, dtype=torch.int32)
    for kw in (dict(kv_dtype="fp8"), dict(kv_dtype="int8"), dict(host_blocks=2)):
        cache = model.init_paged_cache(2, 5, 4, 2, **kw)
        with pytest.raises(NotImplementedError):
            model.paged_verify_step(params, cache, toks)


@pytest.mark.parametrize("k", [0, 2, 4])
def test_spec_verify_tokens_greedy_matches_reference(k):
    """Greedy verify on the same logits: ``emitted`` and ``n_accept`` equal
    JAX's, with drafts that match a prefix of each row's argmax."""
    B, V = 4, 16
    logits = np.random.default_rng(7).standard_normal((B, k + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1).astype(np.int32)
    drafts = None
    if k:
        drafts = tgt[:, :k].copy()
        for b in range(B):                       # row b mismatches at position b
            if b < k:
                drafts[b, b] = (drafts[b, b] + 1) % V
        drafts = drafts.astype(np.int32)
    cfg = SamplerConfig()
    je, jn = jsampler.spec_verify_tokens(
        jnp.asarray(logits), None if drafts is None else jnp.asarray(drafts), None,
        jax.random.key(0), jsampler.SamplerConfig())
    e, n = spec_verify_tokens(torch.from_numpy(logits),
                              None if drafts is None else torch.from_numpy(drafts), None,
                              None, cfg)
    assert e.dtype == n.dtype == torch.int32
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    d_tok, probs = spec_draft_sample(torch.from_numpy(logits[:, 0]), None, cfg)
    assert probs is None and d_tok.tolist() == tgt[:, 0].tolist()


def _first_tokens(t_logits: torch.Tensor, d_logits: torch.Tensor, cfg, n: int,
                  seed: int) -> np.ndarray:
    """``n`` independent draft -> verify rounds in one batch of ``n`` rows
    (the same logits in each); the first emitted token of each."""
    gen = torch.Generator().manual_seed(seed)
    k = d_logits.shape[1]
    drafts, probs = [], []
    for j in range(k):
        tok, q = spec_draft_sample(d_logits[:, j].expand(n, -1), gen, cfg)
        drafts.append(tok)
        probs.append(q)
    emitted, _ = spec_verify_tokens(t_logits.expand(n, -1, -1), torch.stack(drafts, 1),
                                    torch.stack(probs, 1), gen, cfg)
    return emitted[:, 0].numpy()


def _within(counts: np.ndarray, p_t: np.ndarray, n: int, sigmas: float) -> None:
    for v in range(len(p_t)):
        sigma = max(math.sqrt(n * p_t[v] * (1 - p_t[v])), 1.0)
        assert abs(counts[v] - n * p_t[v]) < sigmas * sigma, (v, counts[v], n * p_t[v])


@pytest.mark.parametrize("cfg", [SamplerConfig(temperature=1.0),
                                 SamplerConfig(temperature=0.7, top_k=5)],
                         ids=["temperature", "top-k"])
def test_rejection_sampling_preserves_target_distribution(cfg):
    """A bad draft (logits twice as spread as the target's, drawn
    independently): the first emitted token's counts over 20,000 rounds
    stay within 5 sigma of the target's modified softmax; top-k never
    emits a truncated token."""
    V, k, N = 8, 2, 20_000
    gen = torch.Generator().manual_seed(10)
    t_logits = torch.randn(1, k + 1, V, generator=gen)
    d_logits = 2.0 * torch.randn(1, k, V, generator=gen)
    p_t = torch.softmax(_transformed(t_logits[:, 0], cfg), -1)[0].numpy()
    counts = np.bincount(_first_tokens(t_logits, d_logits, cfg, N, 12),
                         minlength=V).astype(float)
    _within(counts, p_t, N, 5)
    if cfg.top_k:
        assert np.all(counts[p_t == 0.0] == 0)


def test_rejection_sampling_hypothesis():
    """The distribution test over random logits, depths and seeds."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 3))
    @hyp.settings(max_examples=10, deadline=None)
    def run(seed, k):
        cfg = SamplerConfig(temperature=1.0)
        V, N = 6, 4_000
        gen = torch.Generator().manual_seed(seed)
        t_logits = torch.randn(1, k + 1, V, generator=gen)
        d_logits = torch.randn(1, k, V, generator=gen)
        p_t = torch.softmax(_transformed(t_logits[:, 0], cfg), -1)[0].numpy()
        counts = np.bincount(_first_tokens(t_logits, d_logits, cfg, N, seed + 1),
                             minlength=V).astype(float)
        _within(counts, p_t, N, 6)

    run()


def test_rejection_sampling_exhausted_residual_and_full_acceptance():
    """A draft equal to the target accepts every token (u * p < p for u
    < 1), so the bonus token comes from ``p_t`` through the zero-padded
    draft row; with T = 1 (no drafts) the one token is a plain target
    sample."""
    cfg = SamplerConfig(temperature=1.0)
    V, N = 5, 8_000
    gen = torch.Generator().manual_seed(3)
    t_logits = torch.randn(1, 3, V, generator=gen)
    g = torch.Generator().manual_seed(4)
    drafts, probs = [], []
    for j in range(2):
        tok, q = spec_draft_sample(t_logits[:, j].expand(N, -1), g, cfg)
        drafts.append(tok)
        probs.append(q)
    emitted, n_accept = spec_verify_tokens(t_logits.expand(N, -1, -1),
                                           torch.stack(drafts, 1), torch.stack(probs, 1),
                                           g, cfg)
    assert bool((n_accept == 2).all())
    p_bonus = torch.softmax(t_logits[0, 2], -1).numpy()
    _within(np.bincount(emitted[:, 2].numpy(), minlength=V).astype(float), p_bonus, N, 5)
    e0, n0 = spec_verify_tokens(t_logits[:, :1].expand(N, -1, -1), None, None, g, cfg)
    assert e0.shape == (N, 1) and bool((n0 == 0).all())
    p0 = torch.softmax(t_logits[0, 0], -1).numpy()
    _within(np.bincount(e0[:, 0].numpy(), minlength=V).astype(float), p0, N, 5)


@pytest.mark.parametrize("bs", [128, 256, 48])
def test_paged_kernel_checks_take_block_sizes_over_64(bs):
    """The kernel's argument checks take any block size (the reference's
    ``--block-size`` is any int), and the plain version at that size
    equals the JAX oracle's."""
    from repro.kernels import ref as jref

    B, Hkv, G, D, MB = 2, 2, 4, 64, 3
    N = B * MB + 1
    rng = np.random.default_rng(bs)
    q = _bf16(rng.standard_normal((B, Hkv * G, D), np.float32))
    kp, vp = (_bf16(rng.standard_normal((N, Hkv, bs, D), np.float32)) for _ in range(2))
    tables = np.array([[1, 4, 6], [2, 0, 0]], np.int32)
    lengths = np.array([2 * bs + 5, bs - 1], np.int32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
    tt = torch.from_numpy(tables)
    assert kpaged.check_args(tq, tk, tv, tt) == (B, Hkv, bs, G, D, MB)
    with pytest.raises(ValueError, match="G <= 8"):
        kpaged.check_args(tq.repeat(1, 3, 1), tk, tv, tt)
    out = ref.paged_decode_attention(tq, tk, tv, tt, torch.from_numpy(lengths))
    jout = jref.paged_decode_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
                                       jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-2, rtol=2e-2)
