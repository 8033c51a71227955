"""The port's speculative engine against the JAX engine, in float32 mode
(f32 weights and activations, bf16 KV) with the same target and draft
weights carried across as numpy: {dense, paged} x {decode-only, hybrid}
x {sync, async} with a mismatched draft, then a preemption refold, an
EOS inside an accepted window, the in-flight charges of ``k+1``, full
acceptance with the target as its own draft, the refusals, the step
counts of ``benchmarks/spec_bench.py``'s workload and the serve CLI.
Greedy tokens, per-request step stamps, ``EngineStats`` (acceptance
samples included) and ``PoolStats`` must be equal: the step clock does
not depend on the machine, so any difference is a fault.

The reference's paged async engine runs with its ``sync_slot`` race
removed (``_copied_table_rows``, as in ``tests/test_torch_hybrid.py``).
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
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request

PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),
           np.arange(4, 25, dtype=np.int32)]          # multi-chunk
PREEMPT = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
COMBOS = {
    "dense/decode-only": {},
    "dense/hybrid": dict(schedule="hybrid", prefill_chunk=8),
    "paged/decode-only": dict(cache_kind="paged", block_size=8),
    "paged/hybrid": dict(cache_kind="paged", block_size=8, schedule="hybrid",
                         prefill_chunk=8),
}
MODES = {"sync": False, "async": True}


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
    """(JAX model, target params, draft params), the port's the same:
    the draft is the target's config with other weights (seed 1), so its
    proposals mostly miss and the rejection path runs for real."""
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jp, jd = jmodel.init(jax.random.key(0)), jmodel.init(jax.random.key(1))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    p, d = (params_from_numpy(jax.tree.map(np.asarray, x), "cpu") for x in (jp, jd))
    return (jmodel, jp, jd), (model, p, d)


def _run(engine_cls, request_cls, model, params, prompts, n_new, eos_id=-1, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 32)
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new, eos_id=eos_id)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


def _same(models, prompts, n_new, draft="mismatched", **kw):
    """Both engines on one workload, ``draft`` the mismatched draft or the
    target itself; everything observable must agree.  Returns the port's
    requests, stats and engine."""
    (jmodel, jp, jd), (model, p, d) = models
    runs = []
    for eng_cls, req_cls, m, tp, dp in ((JEngine, JRequest, jmodel, jp, jd),
                                        (Engine, Request, model, p, d)):
        spec = {}
        if kw.get("spec_depth"):
            spec = dict(draft_model=m, draft_params=tp if draft == "target" else dp)
        runs.append(_run(eng_cls, req_cls, m, tp, prompts, n_new, **{**kw, **spec}))
    (jreqs, jstats, jeng), (reqs, stats, eng) = runs
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0 and r.in_flight_steps == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.acceptance_rate == jstats.acceptance_rate
    if kw.get("cache_kind") == "paged":
        assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
        assert eng.pool.in_use == 0
    return reqs, stats, eng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("combo", COMBOS)
def test_spec_engine_matches_reference(models, combo, mode):
    """Depth 2, a mismatched draft: tokens, stamps and stats equal the JAX
    engine's, and the tokens equal the port's own plain run."""
    reqs, stats, eng = _same(models, PROMPTS, 5, spec_depth=2, async_mode=MODES[mode],
                             **COMBOS[combo])
    assert stats.spec_steps >= 1 and stats.drafted_tokens == 2 * len(stats.spec_accept_samples)
    assert eng.dispatch_counts["spec"] >= 1
    if "schedule" in COMBOS[combo]:
        assert eng.dispatch_counts["spec_fused"] >= 1 and stats.boundary_packs == 0
    model, params, _ = models[1]
    plain, _, _ = _run(Engine, Request, model, params, PROMPTS, 5, **COMBOS[combo])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", ["decode-only", "hybrid"])
def test_spec_preemption_refold_matches_reference(models, schedule, mode):
    """8 usable blocks of 4: block pressure preempts a speculating slot,
    whose pending windows are observed before its refold."""
    kw = dict(cache_kind="paged", block_size=4, n_blocks=9)
    if schedule == "hybrid":
        kw |= dict(schedule="hybrid", prefill_chunk=8)
    _, stats, _ = _same(models, PREEMPT, 10, spec_depth=2, async_mode=MODES[mode], **kw)
    assert stats.preemptions >= 1


@pytest.mark.parametrize("combo", ["dense/decode-only", "paged/hybrid"])
def test_spec_target_as_draft_accepts_every_window(models, combo):
    """The target as its own draft, as in the JAX engine.  On the hybrid
    schedule both caches are prefilled in the same chunks and every
    drafted token is accepted.  Decode-only prefills the target's prompt
    whole and the draft's in chunks of ``prefill_chunk``: the K/V differ
    in the last bits, and one window of the 12 (in both engines) sees the
    argmax flip on a near-tie."""
    _, stats, _ = _same(models, PROMPTS, 8, draft="target", spec_depth=2,
                         **COMBOS[combo])
    assert stats.accepted_tokens > 0
    if combo == "paged/hybrid":
        assert stats.acceptance_rate == 1.0
    else:
        assert stats.acceptance_rate >= 0.9


@pytest.mark.parametrize("mode", MODES)
def test_spec_eos_inside_accepted_window(models, mode):
    """Depth 4 with the target as draft: whole windows are accepted, and
    an EOS in the middle of one truncates the stream where plain decoding
    stops."""
    model, params, _ = models[1]
    ref, _, _ = _run(Engine, Request, model, params, PREEMPT, 8)
    eos = ref[0].out_tokens[3]
    reqs, stats, _ = _same(models, PREEMPT, 8, draft="target", eos_id=eos, spec_depth=4,
                           async_mode=MODES[mode])
    plain, _, _ = _run(Engine, Request, model, params, PREEMPT, 8, eos_id=eos)
    assert stats.acceptance_rate > 0.5
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]
    assert reqs[0].out_tokens[-1] == eos and len(reqs[0].out_tokens) == 4


def test_spec_inflight_charges_match_reference(models):
    """One slot at depth 3: after every step the request's in-flight
    charges and steps equal the JAX engine's; a pending window holds
    ``k+1`` charges for one step."""
    (jmodel, jp, jd), (model, p, d) = models
    depth, traces = 3, []
    for eng_cls, req_cls, m, tp, dp in ((JEngine, JRequest, jmodel, jp, jd),
                                        (Engine, Request, model, p, d)):
        eng = eng_cls(m, tp, n_slots=1, max_seq=64, spec_depth=depth, draft_model=m,
                      draft_params=dp)
        req = req_cls(uid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=20)
        eng.submit(req)
        trace = []
        while eng.step():
            trace.append((req.in_flight, req.in_flight_steps, len(req.out_tokens)))
        eng.run()
        assert req.done and req.in_flight == 0
        traces.append(trace)
    assert traces[1] == traces[0]
    assert any(f == (depth + 1) * s and s > 0 for f, s, _ in traces[1])


def test_spec_refusals_match_reference(models):
    """The reference's checks, in its order, with its exception types."""
    (jmodel, jp, jd), (model, p, d) = models
    small = build_model(reduce_config("llama3.2-1b", vocab=256).with_overrides(
        dtype="float32"), "cpu")
    jsmall = jbuild_model(jreduce_config("llama3.2-1b", vocab=256), Env())
    cases = [
        (dict(spec_depth=-1), ValueError),
        (dict(spec_depth=2), ValueError),                              # no draft
        (dict(spec_depth=2, draft="same", sub_batches=2), NotImplementedError),
        (dict(spec_depth=2, draft="same", no_verify=True), ValueError),
        (dict(spec_depth=2, draft="small"), ValueError),               # vocab
        (dict(spec_depth=2, draft="same", cache_kind="paged", kv_dtype="fp8"),
         NotImplementedError),
        (dict(spec_depth=2, draft="same", cache_kind="paged", host_blocks=4),
         NotImplementedError),
    ]
    for m, tp, dp, sm in ((jmodel, jp, jd, jsmall), (model, p, d, small)):
        for kw, exc in cases:
            kw = dict(kw)
            draft = kw.pop("draft", None)
            target = m
            if kw.pop("no_verify", False):
                target = dataclasses.replace(m, verify_step=None)
            if draft == "same":
                kw |= dict(draft_model=m, draft_params=dp)
            elif draft == "small":
                kw |= dict(draft_model=sm, draft_params=dp)
            with pytest.raises(exc):
                (JEngine if m is jmodel else Engine)(target, tp, n_slots=2, max_seq=32, **kw)
    kq = dataclasses.replace(model, cfg=model.cfg.with_overrides(kv_quant=True))
    with pytest.raises(NotImplementedError, match="kv_quant"):
        Engine(kq, p, n_slots=2, max_seq=32, spec_depth=2, draft_model=model, draft_params=d)
    nopf = dataclasses.replace(model, prefill_step=None)
    with pytest.raises(ValueError, match="prefill_step"):
        Engine(model, p, n_slots=2, max_seq=32, spec_depth=2, draft_model=nopf,
               draft_params=d)


def test_spec_bench_tokens_per_step_match_reference(models):
    """``benchmarks/spec_bench.py``'s workload (16 prompts of 4-9 tokens, 24
    new tokens each, 8 slots, max_seq 64), target as draft: tokens per
    engine step at depths 0 and 2 and their ratio, the bench's
    ``spec_decode_gain``, are the JAX engine's."""
    (jmodel, jp, _), (model, p, _) = models
    rng = np.random.default_rng(2)
    lens = [int(rng.integers(4, 10)) for _ in range(16)]
    prompts = [rng.integers(1, model.cfg.vocab, size=n).astype(np.int32) for n in lens]
    tps = {}
    for depth in (0, 2):
        kw = dict(n_slots=8, max_seq=64)
        if depth:
            kw |= dict(spec_depth=depth)
        _, stats, _ = _same(models, prompts, 24, draft="target", **kw)
        tps[depth] = stats.generated / stats.engine_steps
    assert tps[2] / tps[0] > 1.2          # the bench's floor


def _pick(lines, prefix):
    return next(line for line in lines if line.startswith(prefix))


@pytest.mark.parametrize("cache", [[], ["--cache", "paged", "--schedule", "hybrid",
                                        "--block-size", "4", "--prefill-chunk", "8"]],
                         ids=["dense", "paged-hybrid"])
def test_serve_cli_spec_depth_prints_reference_lines(capsys, monkeypatch, cache):
    """``--spec-depth 2`` with the default reduced draft at reduced size:
    the ``requests=``, ``spec:`` and ``latency:`` lines equal the
    reference CLI's (bf16 here, as the CLIs run; the draft rejects almost
    everything, so the step clock does not depend on near-ties)."""
    flags = ["--reduced", "--requests", "4", "--slots", "2", "--max-new", "5",
             "--max-seq", "32", "--workload-seed", "1", "--spec-depth", "2", *cache]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    for prefix in ("mode:", "requests=", "spec:", "latency:"):
        assert _pick(mine, prefix) == _pick(theirs, prefix), prefix
