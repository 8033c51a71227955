"""The port's serving engine on the DeepSeek family against the JAX
engine: reduced deepseek-v3-671b in float32 mode (f32 weights and
activations, bf16 latent cache) with the same weights carried across as
numpy, on the dense cache with the decode-only schedule (the only one the
reference serves it on).  Greedy tokens, per-request step stamps and
``EngineStats`` must be equal, sync and async, with one decode batch and
with two sub-batches (each sub-batch routes its own tokens and attends
over its view of the latent cache: in both frameworks); the serve CLI's
lines equal the reference CLI's; and the paged cache, the hybrid
schedule and speculation are refused as the reference refuses them (the
family has no paged decode, chunked prefill or verify step), with its
exception types and texts.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.workload import build_workload

ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jreduce_config(ARCH).with_overrides(dtype="float32"), Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(ARCH).with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _run(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, n_slots=4, max_seq=64, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


@pytest.mark.parametrize("sub_batches", [1, 2])
@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_engine_matches_reference(models, async_mode, sub_batches):
    jmodel, jparams, model, params = models
    prompts = [a.prompt for a in build_workload("random", 8, vocab=512, max_seq=64,
                                                max_new=8, seed=3)]
    kw = dict(async_mode=async_mode, sub_batches=sub_batches)
    jreqs, jstats = _run(JEngine, JRequest, jmodel, jparams, prompts, **kw)
    reqs, stats = _run(Engine, Request, model, params, prompts, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.prefills == 8 and stats.decode_steps > 0


@pytest.mark.parametrize("kw", [
    dict(cache_kind="paged"),
    dict(cache_kind="paged", schedule="hybrid"),
    dict(schedule="hybrid"),
    dict(spec_depth=2),
    dict(spec_depth=2, cache_kind="paged"),
], ids=["paged", "paged-hybrid", "hybrid", "spec", "spec-paged"])
def test_unsupported_paths_refused_like_reference(models, kw):
    jmodel, jparams, model, params = models
    jkw, tkw = dict(kw), dict(kw)
    if "spec_depth" in kw:
        jkw.update(draft_model=jmodel, draft_params=jparams)
        tkw.update(draft_model=model, draft_params=params)
    with pytest.raises(Exception) as theirs:
        JEngine(jmodel, jparams, n_slots=2, max_seq=32, **jkw)
    with pytest.raises(Exception) as mine:
        Engine(model, params, n_slots=2, max_seq=32, **tkw)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value).startswith("deepseek has no")


def test_serve_cli_prints_reference_stats(capsys, monkeypatch):
    flags = ["--arch", ARCH, "--reduced", "--requests", "6", "--slots", "3", "--max-seq",
             "64", "--max-new", "6"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()

    def pick(lines, prefix):
        return next(line for line in lines if line.startswith(prefix))

    for prefix in ("mode:", "workload:", "requests=", "latency:"):
        assert pick(mine, prefix) == pick(theirs, prefix), prefix
