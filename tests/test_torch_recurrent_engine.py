"""The port's serving engine on the recurrent families against the JAX
engine: reduced rwkv6-7b and zamba2-1.2b in float32 mode (f32 weights and
activations, f32 recurrent states, zamba2's bf16 K/V cache) with the same
weights carried across as numpy, on the dense cache with the decode-only
schedule (the only one the reference serves them on).  Greedy tokens,
per-request step stamps and ``EngineStats`` must be equal, sync and async,
with one decode batch and with two sub-batches (each sub-batch advances
its view of the states); the serve CLI's lines equal the reference CLI's;
and the paged cache, the hybrid schedule and speculation are refused as
the reference refuses them, with its exception types and texts.

The reference's float32-mode shift and conv leaves start in bf16 and turn
f32 at its first decode step (``test_reference_state_dtype_changes``); the
port holds them in the model's dtype from the start (ROADMAP §3), so the
JAX engine is handed a cache whose leaves already hold that dtype.  Also:
all ten of the reference's arch ids are registered and build.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import all_arch_ids
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.workload import build_workload

RECURRENT = ["rwkv6-7b", "zamba2-1.2b"]
# the leaves the reference allocates in bf16 and its steps return in the
# activation dtype
ACT_LEAVES = ("tm_shift", "cm_shift", "conv")


@pytest.fixture(scope="module", params=RECURRENT)
def models(request):
    arch = request.param
    jmodel = jbuild_model(jreduce_config(arch).with_overrides(dtype="float32"), Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(arch).with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jmodel, jparams, model, params


def _prompts():
    return [a.prompt for a in build_workload("random", 8, vocab=512, max_seq=64, max_new=8,
                                             seed=3)]


def _run(eng, request_cls, prompts):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


def test_all_reference_archs_registered_and_built():
    assert list(ARCHS) == all_arch_ids()
    for arch in ARCHS:
        model = build_model(reduce_config(arch), "cpu")
        assert model.cfg.family == get_config(arch).family
        assert model.n_params() > 0


def test_reference_state_dtype_changes():
    """The JAX engine in float32 mode: the shift / conv leaves are bf16
    until its first decode step and f32 after it, so the states of
    requests admitted before that step are rounded to bf16 and later ones
    are not.  The port's are f32 throughout."""
    for arch in RECURRENT:
        jmodel = jbuild_model(jreduce_config(arch).with_overrides(dtype="float32"), Env())
        jeng = JEngine(jmodel, jmodel.init(jax.random.key(0)), n_slots=2, max_seq=32,
                       async_mode=False)
        model = build_model(reduce_config(arch).with_overrides(dtype="float32"), "cpu")
        eng = Engine(model, model.init(0), n_slots=2, max_seq=32, async_mode=False)
        leaves = [k for k in ACT_LEAVES if k in jeng.cache]
        assert leaves and {str(jeng.cache[k].dtype) for k in leaves} == {"bfloat16"}
        for e, req in ((jeng, JRequest), (eng, Request)):
            e.submit(req(uid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=3))
            e.step()                         # admits (prefill) and decodes once
        assert {str(jeng.cache[k].dtype) for k in leaves} == {"float32"}
        assert {str(eng.cache[k].dtype) for k in leaves} == {"torch.float32"}


@pytest.mark.parametrize("sub_batches", [1, 2])
@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_engine_matches_reference(models, async_mode, sub_batches):
    arch, jmodel, jparams, model, params = models
    kw = dict(n_slots=4, max_seq=64, async_mode=async_mode, sub_batches=sub_batches)
    jeng = JEngine(jmodel, jparams, **kw)
    # the port's dtype from the start (ROADMAP §3): the states in f32
    jeng.cache = {k: v.astype(jnp.float32) if k in ACT_LEAVES else v
                  for k, v in jeng.cache.items()}
    jreqs, jstats = _run(jeng, JRequest, _prompts())
    reqs, stats = _run(Engine(model, params, **kw), Request, _prompts())
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
    arch, jmodel, jparams, model, params = models
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
    assert str(mine.value).startswith(f"{model.cfg.family} has no")


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_prints_reference_stats(arch, capsys, monkeypatch):
    flags = ["--arch", arch, "--reduced", "--requests", "6", "--slots", "3", "--max-seq",
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
