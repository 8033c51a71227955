"""The port's workload generator and open-loop driver against the JAX
package's: ``build_workload`` byte-identical for all six kinds over seeds
and ``rate`` / ``burst`` / ``fan`` / ``turns``, ``grow_prompt`` equal, and
a :class:`WorkloadDriver` run of the port's engine equal to the reference
driver's run of the JAX engine in rounds, resubmissions, tokens,
``EngineStats`` and ``PoolStats``, in float32 mode (f32 weights and
activations, bf16 KV) with the same weights carried across as numpy.
The step clock does not depend on the machine, so every comparison is
exact.

The reference engine runs with its ``sync_slot`` race removed (the table
row is handed over as a copy; see ``tests/test_torch_hybrid.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving import workload as jworkload
from repro.serving.engine import Engine as JEngine
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import workload
from repro_torch.serving.engine import Engine

VOCAB = 512
SHAPES = [  # (n, max_seq, max_new, rate, burst, fan, turns)
    (12, 64, 8, 0.5, 4, 4, 3),
    (9, 32, 4, 2.0, 3, 2, 2),
    (20, 1024, 64, 0.25, 8, 5, 4),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_table_rows(monkeypatch):
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


def _fields(arrivals):
    return [(a.round, a.prompt.dtype.str, a.prompt.tobytes(), a.max_new_tokens, a.session,
             a.turns_left) for a in arrivals]


def test_workload_kinds_are_the_reference_kinds():
    assert workload.WORKLOADS == jworkload.WORKLOADS


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", jworkload.WORKLOADS)
def test_build_workload_is_byte_identical(kind, seed, shape):
    n, max_seq, max_new, rate, burst, fan, turns = SHAPES[shape]
    kw = dict(vocab=VOCAB, max_seq=max_seq, max_new=max_new, seed=seed, rate=rate,
              burst=burst, fan=fan, turns=turns)
    ours = workload.build_workload(kind, n, **kw)
    ref = jworkload.build_workload(kind, n, **kw)
    assert len(ours) == n and _fields(ours) == _fields(ref)
    for a in ours:
        assert len(a.prompt) + max_new <= max_seq - 2       # every arrival admissible


def test_unknown_workload_raises_like_the_reference():
    for mod in (workload, jworkload):
        with pytest.raises(ValueError, match="unknown workload"):
            mod.build_workload("zipf", 4, vocab=VOCAB, max_seq=64, max_new=8)


@pytest.mark.parametrize("case", [
    (np.arange(1, 6), [7, 8], np.array([100, 101, 102]), 32, 4),
    (np.arange(1, 40), list(range(50, 60)), np.array([5, 6]), 32, 4),     # tail-clipped
    (np.arange(1, 3), [], np.array([9]), 8, 4),                            # budget floor 4
])
def test_grow_prompt_matches_reference(case):
    prompt, out, query, max_seq, max_new = case
    prompt, query = prompt.astype(np.int32), query.astype(np.int32)
    ours = workload.grow_prompt(prompt, out, query, max_seq, max_new)
    ref = jworkload.grow_prompt(prompt, out, query, max_seq, max_new)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


ENGINES = {
    "dense/decode-only": dict(n_slots=2, max_seq=48),
    "paged/hybrid": dict(n_slots=2, max_seq=48, cache_kind="paged", block_size=8,
                         schedule="hybrid", prefill_chunk=8),
}
DRIVES = {  # kind -> (n, build_workload keywords)
    "agentic": (3, dict(max_new=4, rate=0.5, turns=3)),
    "rag": (8, dict(max_new=3, rate=1.0)),
}


def _drive(engine_cls, driver_mod, model, params, kind, async_mode, engine_kw):
    n, kw = DRIVES[kind]
    arrivals = driver_mod.build_workload(kind, n, vocab=model.cfg.vocab,
                                         max_seq=engine_kw["max_seq"], seed=5, **kw)
    eng = engine_cls(model, params, async_mode=async_mode, **engine_kw)
    drv = driver_mod.WorkloadDriver(eng, arrivals, vocab=model.cfg.vocab,
                                    max_seq=engine_kw["max_seq"], seed=5)
    return drv, drv.run(), eng


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", DRIVES)
def test_driver_matches_reference(models, kind, engine, mode):
    jmodel, jparams, model, params = models
    kw = ENGINES[engine]
    jdrv, jrounds, jeng = _drive(JEngine, jworkload, jmodel, jparams, kind, mode == "async", kw)
    drv, rounds, eng = _drive(Engine, workload, model, params, kind, mode == "async", kw)
    assert (rounds, drv.resubmits, len(drv.submitted)) == \
        (jrounds, jdrv.resubmits, len(jdrv.submitted))
    for r, j in zip(drv.submitted, jdrv.submitted):
        assert r.done and r.in_flight == 0
        assert r.prompt.tobytes() == np.asarray(j.prompt).tobytes(), r.uid
        assert r.out_tokens == j.out_tokens, r.uid
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    if kind == "agentic":
        n, kw_w = DRIVES[kind]
        assert drv.resubmits == n * (kw_w["turns"] - 1)
    if kw.get("cache_kind") == "paged":
        assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
        if kind == "rag":
            assert eng.pool.stats.hash_hits > 0          # the shared documents hit
