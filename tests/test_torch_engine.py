"""The port's serving engine against the JAX engine, in float32 mode (f32
weights and activations, bf16 KV cache) with the same weights carried
across as numpy, both execution modes.  Greedy tokens must be identical
and ``EngineStats`` equal field for field: the step clock does not
depend on the machine, so any difference is a fault, not noise.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild_model
from repro.serving import kv_cache as jkv
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.workload import build_workload as jbuild_workload
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.workload import build_workload

SERVING_PROMPTS = [np.arange(1, 6, dtype=np.int32),
                   np.arange(7, 10, dtype=np.int32),
                   np.arange(2, 11, dtype=np.int32)]
SAMPLER_PROMPTS = SERVING_PROMPTS[:2] + [np.arange(2, 13, dtype=np.int32),
                                         np.arange(2, 13, dtype=np.int32),
                                         np.arange(4, 25, dtype=np.int32)]


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _run(engine_cls, request_cls, model, params, prompts, async_mode, n_new=5,
         n_slots=2, max_seq=32, eos_id=-1):
    eng = engine_cls(model, params, n_slots=n_slots, max_seq=max_seq,
                     async_mode=async_mode)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new, eos_id=eos_id)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


def _both(models, prompts, async_mode, **kw):
    jmodel, jparams, model, params = models
    jreqs, jstats = _run(JEngine, JRequest, jmodel, jparams, prompts, async_mode, **kw)
    reqs, stats = _run(Engine, Request, model, params, prompts, async_mode, **kw)
    return jreqs, jstats, reqs, stats


def _assert_same(jreqs, jstats, reqs, stats):
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_engine_matches_reference(models, async_mode):
    """tests/test_serving.py's workload: 3 prompts through 2 slots."""
    jreqs, jstats, reqs, stats = _both(models, SERVING_PROMPTS, async_mode)
    _assert_same(jreqs, jstats, reqs, stats)
    assert stats.prefills == 3 and stats.peak_active == 2


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_eos_stops_early_like_reference(models, async_mode):
    """EOS at the 3rd generated token; async sees it one step late and
    masks the token dispatched past it."""
    prompt = [np.arange(1, 5, dtype=np.int32)]
    _, _, model, params = models
    ref, _ = _run(Engine, Request, model, params, prompt, False, n_new=8, n_slots=1)
    eos = ref[0].out_tokens[2]
    jreqs, jstats, reqs, stats = _both(models, prompt, async_mode, n_new=8, n_slots=1,
                                       eos_id=eos)
    assert reqs[0].out_tokens == ref[0].out_tokens[:3]
    _assert_same(jreqs, jstats, reqs, stats)


def test_submit_rejects_prompts_that_overflow_cache(models):
    _, _, model, params = models
    eng = Engine(model, params, n_slots=1, max_seq=16)
    for plen in (15, 16, 20):
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(Request(uid=0, prompt=np.arange(plen, dtype=np.int32),
                               max_new_tokens=4))
    r = Request(uid=1, prompt=np.arange(1, 15, dtype=np.int32), max_new_tokens=4)
    eng.submit(r)
    eng.run()
    assert r.done and len(r.out_tokens) >= 1


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_random_workload_matches_reference(models, async_mode):
    kw = dict(vocab=512, max_seq=64, max_new=8, seed=3)
    arrivals = build_workload("random", 8, **kw)
    jarrivals = jbuild_workload("random", 8, **kw)
    for a, j in zip(arrivals, jarrivals):
        np.testing.assert_array_equal(a.prompt, j.prompt)
    jreqs, jstats, reqs, stats = _both(models, [a.prompt for a in arrivals], async_mode,
                                       n_new=8, n_slots=4, max_seq=64)
    _assert_same(jreqs, jstats, reqs, stats)


def test_sync_and_async_are_token_identical(models):
    _, _, model, params = models
    sync, s_stats = _run(Engine, Request, model, params, SAMPLER_PROMPTS, False, n_new=6)
    asyn, a_stats = _run(Engine, Request, model, params, SAMPLER_PROMPTS, True, n_new=6)
    assert [r.out_tokens for r in sync] == [r.out_tokens for r in asyn]
    assert dataclasses.asdict(s_stats) == dataclasses.asdict(a_stats)


@pytest.mark.parametrize("kw", [
    dict(spec_depth=2, sub_batches=2),     # speculation is ported, over sub-batches not
    dict(sub_batches=2, cache_kind="paged"),   # sub-batches are dense-only, as in the reference
], ids=["spec_depth", "sub_batches"])
def test_unported_engine_options_raise(models, kw):
    _, _, model, params = models
    if "spec_depth" in kw:
        kw = dict(kw, draft_model=model, draft_params=params)
    with pytest.raises(NotImplementedError):
        Engine(model, params, n_slots=1, max_seq=16, **kw)


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="fp8"),
    dict(kv_dtype="int8"),
    dict(host_blocks=4),
], ids=["fp8", "int8", "host_blocks"])
def test_tiered_engine_cache_has_reference_leaves(models, kw):
    """The engine's paged cache with an fp8/int8 pool or a host tier has
    the leaves, shapes and dtypes of the reference's
    ``init_paged_cache(kv_dtype=..., host_blocks=...)``."""
    jmodel, _, model, params = models
    eng = Engine(model, params, n_slots=2, max_seq=16, cache_kind="paged", block_size=4,
                 **kw)
    jcache = jmodel.init_paged_cache(2, eng.n_blocks, 4, eng.max_blocks, **kw)
    assert set(eng.cache) == set(jcache)
    for key, t in eng.cache.items():
        assert tuple(t.shape) == jcache[key].shape, key
        assert str(t.dtype).removeprefix("torch.") == str(jcache[key].dtype), key


def test_serve_cli_prints_reference_stats(capsys, monkeypatch):
    flags = ["--reduced", "--requests", "5", "--slots", "2", "--max-new", "4",
             "--workload-seed", "2"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()

    def pick(lines, prefix):
        return next(line for line in lines if line.startswith(prefix))

    for prefix in ("mode:", "workload:", "requests=", "latency:"):
        assert pick(mine, prefix) == pick(theirs, prefix), prefix


def test_kv_cache_insert_reset_match_reference():
    rng = np.random.default_rng(6)
    base = {"k": rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32),
            "lengths": np.array([1, 2, 3], np.int32)}
    sub = {"k": rng.standard_normal((2, 1, 8, 2, 4)).astype(np.float32),
           "lengths": np.array([7], np.int32)}
    jout = jkv.reset_slot(jkv.insert({k: jax.numpy.asarray(v) for k, v in base.items()},
                                     {k: jax.numpy.asarray(v) for k, v in sub.items()}, 1), 2)
    cache = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
    kv_cache.reset_slot(kv_cache.insert(cache, {k: torch.from_numpy(v) for k, v in
                                                sub.items()}, 1), 2)
    for key in base:
        np.testing.assert_array_equal(cache[key].numpy(), np.asarray(jout[key]))
    view = kv_cache.slot_view(cache, 0)
    view["k"].fill_(5.0)
    assert float(cache["k"][:, 0].min()) == 5.0 and float(cache["k"][:, 1].max()) != 5.0
    assert kv_cache.kv_bytes(cache) == 2 * 3 * 8 * 2 * 4 * 4 + 3 * 4
