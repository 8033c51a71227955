"""The serving engine of a placed model on a 2-rank CPU world (gloo),
on the meshes data 2 x model 1 and data 1 x model 2, under each KV
policy, sync and async, against the JAX engine on one device: the
reduced llama in float32 mode (bf16 cache) with the JAX weights carried
across, ``tests/test_torch_engine.py``'s random workload.  Every rank
runs the same schedule; its tokens, step stamps and ``EngineStats`` equal
the JAX engine's, on every rank.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
from torch_placement_worker import flat, run_world

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import POLICIES, Env
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.workload import build_workload as jbuild_workload

SLOTS, MAX_SEQ, MAX_NEW, VOCAB = 4, 64, 8, 512
MODES = ("sync", "async")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    cfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    m = jbuild_model(cfg, Env())
    params = m.init(jax.random.key(0))
    np.savez(tmp / "params_float32.npz",
             **{k: np.asarray(v, np.float32) for k, v in flat(params)})
    prompts = [a.prompt for a in jbuild_workload("random", 8, vocab=VOCAB, max_seq=MAX_SEQ,
                                                 max_new=MAX_NEW, seed=3)]
    want = {}
    for mode in MODES:
        eng = JEngine(m, params, n_slots=SLOTS, max_seq=MAX_SEQ, async_mode=mode == "async")
        reqs = [JRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        want[mode] = (reqs, dataclasses.asdict(eng.run()))
    outs = run_world(2, dict(kind="engine", model_parallel=[1, 2], vocab=VOCAB,
                             policies=list(POLICIES), slots=SLOTS, max_seq=MAX_SEQ,
                             max_new=MAX_NEW, prompts=[p.tolist() for p in prompts]), tmp)
    return want, outs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mp", [1, 2], ids=["data2", "model2"])
def test_placed_engine_matches_reference(world, mp, policy, mode):
    want, outs = world
    reqs, stats = want[mode]
    key = f"{mp}/{policy}/{mode}"
    for o in outs:
        for r in reqs:
            assert o[f"{key}/tokens{r.uid}"].tolist() == r.out_tokens, r.uid
            assert o[f"{key}/stamps{r.uid}"].tolist() == [
                r.submit_step, r.admit_step, r.first_token_step, r.finish_step]
        assert json.loads(str(o[f"{key}/stats"])) == stats


def test_gather_from_all_reduce_equals_all_gather(world):
    """gloo's route for CUDA tensors, once a gather built from all_reduce
    and now the ring of sends and receives (``collectives._ring_gather``),
    gives what its all_gather gives, bit for bit (bf16)."""
    _, outs = world
    for o in outs:
        np.testing.assert_array_equal(o["by_sum"], o["native"])
        assert o["native"][1, 0, 0] == -10
