"""The port's dense model against the JAX package with the same weights
(built by ``repro``, carried across as numpy): a prefill, then four
decode steps, on reduced llama3.2-1b.

Tolerances: logits 1e-4 in float32 mode (f32 weights and activations,
bf16 KV cache, as the reference engine runs in its tests); 0.1 absolute
on logits in bf16 mode, where both frameworks round activations to bf16
at slightly different places (logits here are O(1)..O(10)).  Cache
contents below ``lengths`` are compared to one bf16 ulp (2**-7 relative)
in float32 mode, and at the bf16 logit tolerance in bf16 mode, where the
K/V themselves come out of bf16 activations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.sampler import SamplerConfig

B, S0, MAX_SEQ, N_DECODE = 2, 7, 16, 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}


def _models(dtype):
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype=dtype)
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype=dtype), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert params["blocks"]["wq"].dtype == getattr(torch, dtype)
    return jmodel, jparams, model, params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    jmodel, jparams, model, params = _models(dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 512, size=(B, S0)).astype(np.int32)
    steps = rng.integers(1, 512, size=(N_DECODE, B)).astype(np.int32)
    tol = LOGIT_TOL[dtype]

    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                              jmodel.init_cache(B, MAX_SEQ))
    cache = model.init_cache(B, MAX_SEQ)
    logits, cache = model.prefill(params, torch.from_numpy(prompt), cache)
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
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(cache[key][:, :, :n]), _np(jcache[key][:, :, :n]),
                                   rtol=2**-7, atol=1e-6 if dtype == "float32" else tol)


def test_decode_step_at_full_cache_skips_the_write():
    """A slot whose length equals max_seq (an idle slot that ran past the
    end) must not write out of range: the reference drops the scatter,
    the port skips it.  The other slot is unaffected."""
    jmodel, jparams, model, params = _models("float32")
    rng = np.random.default_rng(1)
    k0 = rng.standard_normal((2, B, MAX_SEQ, 2, 16)).astype(np.float32)
    lengths = np.array([MAX_SEQ, 5], np.int32)
    tokens = np.array([3, 4], np.int32)
    jcache = {"k": jnp.asarray(k0, jnp.bfloat16), "v": jnp.asarray(-k0, jnp.bfloat16),
              "lengths": jnp.asarray(lengths)}
    cache = {"k": torch.from_numpy(k0).bfloat16(), "v": torch.from_numpy(-k0).bfloat16(),
             "lengths": torch.from_numpy(lengths.copy())}
    before = cache["k"][:, 0].clone()
    jlogits, jcache = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(tokens))
    logits, cache = model.decode_step(params, cache, torch.from_numpy(tokens))
    assert torch.equal(cache["k"][:, 0], before)
    np.testing.assert_array_equal(cache["lengths"].numpy(), [MAX_SEQ + 1, 6])
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]), rtol=2**-7, atol=1e-6)
    # and once more, with the length now past max_seq
    jlogits, _ = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(tokens))
    logits, _ = model.decode_step(params, cache, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4)


def test_decode_sample_step_greedy_and_eos():
    _, _, model, params = _models("float32")
    cache = model.init_cache(B, MAX_SEQ)
    prompt = torch.arange(1, 1 + B * S0).reshape(B, S0)
    model.prefill(params, prompt, cache)
    probe = {k: v.clone() for k, v in cache.items()}
    logits, _ = model.decode_step(params, probe, torch.tensor([5, 6]))
    greedy = logits.argmax(-1).to(torch.int32)
    eos_ids = torch.tensor([int(greedy[0]), -1], dtype=torch.int32)
    tok, eos, cache = model.decode_sample_step(params, cache, torch.tensor([5, 6]), None,
                                               eos_ids, sampler=SamplerConfig())
    assert torch.equal(tok, greedy)
    assert eos.tolist() == [True, False]


def test_entry_points_need_an_explicit_cpu_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(reduce_config("llama3.2-1b"))
