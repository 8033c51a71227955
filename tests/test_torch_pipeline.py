"""Sub-batch pipelining (paper Fig. 3) in the port against the JAX
package's ``core.pipeline`` and engine: split and merge of trees and
caches equal the reference's functions on the same arrays (the port's
parts are views: a write into a part lands in the whole); an engine with
``sub_batches=2``, sync and async, equals the JAX engine with
``sub_batches=2`` in greedy tokens, step stamps and ``EngineStats`` (in
float32 mode: f32 weights and activations, bf16 KV, the same weights
carried across as numpy), and its own ``sub_batches=1`` run's tokens; and
the paged, hybrid and speculative engines refuse it as the reference
does, with its exception types and texts, in its order.  On the CPU the
sub-batches run one after another; the CUDA streams are exercised on the
card (``tests/test_torch_cuda_cluster.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core import pipeline as jpipe
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import pipeline as pipe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(7, 10, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),
           np.arange(4, 25, dtype=np.int32),
           np.arange(3, 9, dtype=np.int32)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_table_rows(monkeypatch):
    """The reference's ``device.sync_slot`` may push an aliased numpy row
    that its manager rewrites before the push has run (ROADMAP.md §3);
    hand it a copy, as ``tests/test_torch_hybrid.py`` does.  The engines
    here are dense, so this only guards a paged one added later."""
    push = jdev.sync_slot

    def sync_slot(cache, slot, row, length=None):
        return push(cache, slot, np.array(row, np.int32), length)

    monkeypatch.setattr(jdev, "sync_slot", sync_slot)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _tree(rng):
    """A tree of (L, B, ...) leaves and a (B,) one, as numpy."""
    return {"k": rng.standard_normal((2, 4, 3, 2)).astype(np.float32),
            "v": rng.standard_normal((2, 4, 3, 2)).astype(np.float32),
            "lengths": rng.integers(0, 9, 4).astype(np.int32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _from_torch(tree):
    if isinstance(tree, dict):
        return {k: _from_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_torch(v) for v in tree]
    return tree.numpy()


def _equal(mine, theirs):
    jax.tree.map(np.testing.assert_array_equal, _from_torch(mine), _np(theirs))


@pytest.mark.parametrize("n_sub", [1, 2, 4])
def test_tree_split_and_concat_match_reference(n_sub):
    rng = np.random.default_rng(n_sub)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.integers(0, 5, (8, 2)).astype(np.int32)}}
    mine = pipe.tree_split({"a": torch.from_numpy(tree["a"]),
                            "b": {"c": torch.from_numpy(tree["b"]["c"])}}, n_sub)
    theirs = jpipe.tree_split(jax.tree.map(jnp.asarray, tree), n_sub)
    assert len(mine) == len(theirs) == n_sub
    for m, t in zip(mine, theirs):
        _equal(m, t)
    _equal(pipe.tree_concat(mine), jpipe.tree_concat(theirs))


@pytest.mark.parametrize("n_sub", [2, 4])
def test_split_and_merge_cache_match_reference(n_sub):
    tree = _tree(np.random.default_rng(7))
    cache = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    jcache = jax.tree.map(jnp.asarray, tree)
    axes = pipe.default_batch_axes(cache)
    assert axes == jpipe.default_batch_axes(jcache) == {"k": 1, "v": 1, "lengths": 0}
    mine, theirs = pipe.split_cache(cache, n_sub, axes), jpipe.split_cache(jcache, n_sub, axes)
    for m, t in zip(mine, theirs):
        _equal(m, t)
    _equal(pipe.merge_cache(mine, axes), jpipe.merge_cache(theirs, axes))
    # the parts are views of the cache: no sub-batch copies it
    for part in mine:
        for key, t in part.items():
            assert t.untyped_storage().data_ptr() == cache[key].untyped_storage().data_ptr()
    mine[-1]["lengths"].add_(100)
    tail = slice(4 - 4 // n_sub, 4)
    np.testing.assert_array_equal(cache["lengths"][tail].numpy(), tree["lengths"][tail] + 100)


def test_split_refuses_an_unequal_division():
    cache = {k: torch.from_numpy(v) for k, v in _tree(np.random.default_rng(0)).items()}
    with pytest.raises(ValueError, match="equal division"):
        pipe.split_cache(cache, 3, pipe.default_batch_axes(cache))
    with pytest.raises(ValueError, match="equal division"):
        jpipe.split_cache(jax.tree.map(jnp.asarray, _np(cache)), 3,
                          jpipe.default_batch_axes(cache))


def test_pipelined_step_writes_the_cache_in_place():
    """A toy decode step (logits from the tokens, lengths + 1) through
    ``pipelined_step``: the reference's logits and cache; the port's
    returns the very cache it was given."""

    def decode(params, cache, tokens):
        cache["lengths"].add_(1)
        return tokens[:, None].float() * params, cache

    def jdecode(params, cache, tokens):
        return tokens[:, None].astype(jnp.float32) * params, {
            **cache, "lengths": cache["lengths"] + 1}

    tree = _tree(np.random.default_rng(3))
    cache = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tokens = np.arange(4, dtype=np.int32) + 3
    logits, out = pipe.pipelined_step(decode, 2)(2.0, cache, torch.from_numpy(tokens))
    jlogits, jout = jpipe.pipelined_step(jdecode, 2)(2.0, jax.tree.map(jnp.asarray, tree),
                                                     jnp.asarray(tokens))
    assert out is cache
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
    _equal(cache, jout)
    assert pipe.pipelined_step(decode, 1) is decode


def _run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, n_slots=4, max_seq=32, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sub_batch_engine_matches_reference(models, mode):
    jmodel, jparams, model, params = models
    kw = dict(sub_batches=2, async_mode=mode == "async")
    jreqs, jstats, _ = _run(JEngine, JRequest, jmodel, jparams, **kw)
    reqs, stats, eng = _run(Engine, Request, model, params, **kw)
    assert eng.sub_batches == 2
    for j, r in zip(jreqs, reqs):
        assert r.done and r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    plain, _, _ = _run(Engine, Request, model, params, async_mode=mode == "async")
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]


def _refusal(engine_cls, model, params, **kw):
    with pytest.raises(Exception) as err:
        engine_cls(model, params, n_slots=4, max_seq=32, sub_batches=2, **kw)
    return type(err.value), str(err.value)


@pytest.mark.parametrize("case", ["paged", "hybrid", "spec", "paged-hybrid-spec"])
def test_sub_batch_refusals_match_reference(models, case):
    """Pipelining is dense, decode-only and not speculative; where several
    refusals apply the reference's first one is raised."""
    jmodel, jparams, model, params = models
    kw = {"paged": dict(cache_kind="paged"),
          "hybrid": dict(schedule="hybrid"),
          "spec": dict(spec_depth=2),
          "paged-hybrid-spec": dict(cache_kind="paged", schedule="hybrid", spec_depth=2)}[case]
    draft = lambda m, p: dict(draft_model=m, draft_params=p) if "spec" in case else {}  # noqa: E731
    ours = _refusal(Engine, model, params, **kw, **draft(model, params))
    theirs = _refusal(JEngine, jmodel, jparams, **kw, **draft(jmodel, jparams))
    assert ours == theirs
    assert ours[0] is NotImplementedError and "sub-batch pipelining" in ours[1]
