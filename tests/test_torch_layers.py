"""The port's configs, layers, parameter definitions and sampler against
the JAX package, on inputs made from numpy seeds.

Tolerances: f32 layers 1e-5 (different summation order and transcendental
implementations); bf16 layers one bf16 ulp at the values' scale, 1e-2
relative.  Sampling distributions: every bin within 5 standard errors of
the exact probability over 20000 draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.serving.sampler import SamplerConfig as JSamplerConfig
from repro.serving.sampler import sample as jsample
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.serving.sampler import SamplerConfig, sample, sample_on_device

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _both(x: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    mine = reduce_config("llama3.2-1b") if reduced else get_config("llama3_2-1B")
    theirs = jreduce_config("llama3.2-1b") if reduced else jget_config("llama3.2-1b")
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.padded_vocab() == theirs.padded_vocab()
    assert mine.resolved_head_dim() == theirs.resolved_head_dim()
    assert mine.with_overrides(dtype="float32").dtype == "float32"


def test_param_defs_match_reference():
    cfg, jcfg = reduce_config("llama3.2-1b"), jreduce_config("llama3.2-1b")
    flat = dict(cm._leaves(dense.param_defs(cfg)))
    jflat = {tuple(k.key for k in path): d for path, d in
             jax.tree_util.tree_flatten_with_path(jdense.param_defs(jcfg),
                                                  is_leaf=jcm.is_def)[0]}
    assert flat.keys() == jflat.keys()
    for key, d in flat.items():
        assert (d.shape, d.logical, d.init) == (jflat[key].shape, jflat[key].logical,
                                                jflat[key].init), key


def test_init_params_samples_the_reference_distributions():
    cfg = get_config("llama3.2-1b").with_overrides(n_layers=1, vocab=1024, d_ff=1024)
    gen = torch.Generator().manual_seed(0)
    params = cm.init_params(dense.param_defs(cfg), gen, torch.float32, torch.device("cpu"))
    assert float(params["blocks"]["ln1"].abs().max()) == 0.0
    assert float(params["final_norm"].abs().max()) == 0.0
    # fan-in is shape[-2], as in the reference: wq (L, D, Hq, Dh) -> Hq
    for key, std in (("wq", 1 / np.sqrt(cfg.n_heads)), ("w_down", 1 / np.sqrt(1024))):
        got = float(params["blocks"][key].std())
        assert abs(got - std) < 0.02 * std, (key, got, std)
    assert abs(float(params["embed"].std()) - 0.02) < 0.02 * 0.02
    again = cm.init_params(dense.param_defs(cfg), torch.Generator().manual_seed(0),
                           torch.float32, torch.device("cpu"))
    assert torch.equal(again["blocks"]["wq"], params["blocks"]["wq"])


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    (jx, tx), (js, ts) = _both(rng.standard_normal((2, 5, 64), np.float32), dtype), \
        _both(0.1 * rng.standard_normal(64).astype(np.float32), dtype)
    np.testing.assert_allclose(_np(cm.rmsnorm(tx, ts)), _np(jcm.rmsnorm(jx, js)),
                               rtol=RTOL[dtype], atol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 7, 4, 16), np.float32), dtype)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(cm.rope(tx, torch.from_numpy(pos), 500000.0)),
        _np(jcm.rope(jx, jnp.asarray(pos), 500000.0)),
        rtol=RTOL[dtype], atol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(s, np.float32) / np.sqrt(s[0])
              for s in ((64, 128), (64, 128), (128, 64))]
    (jx, tx) = _both(rng.standard_normal((3, 64), np.float32), dtype)
    (jg, tg), (ju, tu), (jd, td) = (_both(a, dtype) for a in arrays)
    np.testing.assert_allclose(_np(cm.swiglu(tx, tg, tu, td)),
                               _np(jcm.swiglu(jx, jg, ju, jd)),
                               rtol=RTOL[dtype], atol=RTOL[dtype])


def test_embed_lookup_and_unembed_pad_mask():
    rng = np.random.default_rng(3)
    jt, tt = _both(rng.standard_normal((512, 64), np.float32))
    tokens = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(cm.embed_lookup(tt, torch.from_numpy(tokens))),
        _np(jcm.embed_lookup(jt, jnp.asarray(tokens))))
    jx, tx = _both(rng.standard_normal((2, 64), np.float32))
    mine = cm.unembed(tx, tt, true_vocab=500)
    np.testing.assert_allclose(_np(mine), _np(jcm.unembed(jx, jt, true_vocab=500)),
                               rtol=1e-5, atol=1e-5)
    assert float(mine[:, 500:].max()) == float(np.float32(-1e30))
    assert float(mine[:, :500].min()) > -1e29


# ------------------------------------------------------------------ sampler
def test_greedy_sampling_matches_reference_including_ties():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 64)).astype(np.float32)
    logits[1, [3, 9]] = 10.0                 # tie: the first index wins
    logits[4, [0, 63]] = 10.0
    expect = np.asarray(jsample(jnp.asarray(logits), jax.random.key(0), JSamplerConfig()))
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(sample(t, None, SamplerConfig()).numpy(), expect)
    dev = sample_on_device(t, None, SamplerConfig())
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), expect)


@pytest.mark.parametrize("cfg", [SamplerConfig(temperature=0.7),
                                 SamplerConfig(temperature=1.3, top_k=3)],
                         ids=["temperature", "top-k"])
@pytest.mark.parametrize("fn", [sample, sample_on_device], ids=["host", "device"])
def test_sampling_distribution(cfg, fn):
    logits = torch.tensor([[1.0, 0.5, 0.2, -0.3, 0.9, -1.0, 0.0, 0.4]])
    scaled = logits / cfg.temperature
    if cfg.top_k:
        kth = scaled.topk(cfg.top_k).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    p = torch.softmax(scaled, -1)[0].numpy()
    n = 20000
    gen = torch.Generator().manual_seed(7)
    draws = fn(logits.expand(n, -1).contiguous(), gen, cfg).numpy()
    freq = np.bincount(draws, minlength=8) / n
    se = np.sqrt(np.maximum(p * (1 - p), 1e-12) / n)
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-12), (freq, p)
    if cfg.top_k:
        assert set(np.unique(draws)) <= set(np.argsort(-p)[:cfg.top_k].tolist())
