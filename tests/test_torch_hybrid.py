"""The port's engine on the paged cache and the hybrid schedule against the
JAX engine, in float32 mode (f32 weights and activations, bf16 KV) with
the same weights carried across as numpy: {dense, paged} x {decode-only,
hybrid} x {sync, async}, on the prompt sets of ``tests/test_scheduler.py``
and ``tests/test_paged.py`` (prefix sharing, an exact block multiple,
block-gated admission, preemption with exact refold, boundary packing).
Greedy tokens, per-request step stamps, ``EngineStats`` and ``PoolStats``
must be equal: the step clock does not depend on the machine, so any
difference is a fault, not noise.  One case differs on purpose: a
boundary-packed newcomer whose shared prefix block the same dispatch
writes is recomputed by the port and read unwritten by the reference
(ROADMAP.md §3); there the tokens are held to the reference's dense
engine and the pool's bookkeeping to its paged engine.

The reference engine runs with one race removed (``_copied_table_rows``):
its ``device.sync_slot`` pushes ``manager.tables[slot]`` through
``jnp.asarray``, which on the CPU may alias a 64-byte-aligned numpy row
instead of copying it, and the manager rewrites that row in place while
the asynchronously dispatched push may not have run yet.  The JAX
package is not changed; the test hands it a copy of the row, which is
what its code means.
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
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.telemetry import Tracer

SHARED = np.arange(2, 13, dtype=np.int32)
MIXED = [np.arange(1, 6, dtype=np.int32), SHARED, SHARED,
         np.arange(1, 17, dtype=np.int32),          # exact multiple of block 8
         np.arange(4, 25, dtype=np.int32)]          # multi-chunk
PREEMPT = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
GATED = [np.arange(1, 9, dtype=np.int32), np.arange(11, 19, dtype=np.int32)]

SCHEDULES = {"decode-only": {}, "hybrid": dict(schedule="hybrid", prefill_chunk=8)}
CACHES = {"dense": {}, "paged": dict(cache_kind="paged", block_size=8)}
MODES = {"sync": False, "async": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads; one thread
    keeps this module from crowding the other test workers."""
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


def _run(engine_cls, request_cls, model, params, prompts, n_new, eos_id=-1, **kw):
    eng = engine_cls(model, params, n_slots=2, max_seq=32, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new, eos_id=eos_id)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


def _same(models, prompts, n_new, **kw):
    """Both engines on one workload; everything observable must agree.
    Returns the port's stats and engine."""
    jmodel, jparams, model, params = models
    jreqs, jstats, jeng = _run(JEngine, JRequest, jmodel, jparams, prompts, n_new, **kw)
    reqs, stats, eng = _run(Engine, Request, model, params, prompts, n_new, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0 and r.in_flight_steps == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    if kw.get("cache_kind") == "paged":
        assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
        assert eng.pool.in_use == 0 and eng.kv_bytes() == jeng.kv_bytes()
    return stats, eng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cache", CACHES)
def test_engine_matches_reference(models, cache, schedule, mode):
    """Mixed lengths, a shared prefix, an exact block multiple and a
    multi-chunk prompt through 2 slots."""
    stats, eng = _same(models, MIXED, 5, async_mode=MODES[mode], **CACHES[cache],
                       **SCHEDULES[schedule])
    assert stats.peak_active == 2 and stats.prefills == len(MIXED)
    if schedule == "hybrid":
        assert stats.prefill_chunks > stats.prefills       # chunking happened
        if cache == "paged":
            assert eng.pool.stats.hash_hits >= 1           # prefix cache exercised
        else:
            assert stats.boundary_packs >= 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_preemption_refold_matches_reference(models, schedule, mode):
    """8 usable blocks of 4 tokens: both sequences cannot finish resident,
    the youngest is preempted and re-prefilled from prompt + output."""
    stats, _ = _same(models, PREEMPT, 10, async_mode=MODES[mode], cache_kind="paged",
                     block_size=4, n_blocks=9, **SCHEDULES[schedule])
    assert stats.preemptions >= 1
    if mode == "async":
        assert stats.victim_drains >= 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_block_gated_admission_matches_reference(models, schedule, mode):
    """The pool holds one max-length sequence: the second request waits
    for blocks although a slot is free."""
    _same(models, GATED, 4, async_mode=MODES[mode], cache_kind="paged", block_size=4,
          n_blocks=9, **SCHEDULES[schedule])


# request 1 (1..16) shares its first block of 4 with request 0 (1..5), and
# begins, boundary-packed, in the dispatch of request 0's only chunk
BOUNDARY = MIXED[:1] + MIXED[3:] + MIXED[1:2]
BOUNDARY_KW = dict(cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=16,
                   token_budget=18)
# EngineStats fields that request 1's recomputed block moves
RECOMPUTE_MOVES = ("prefill_chunks", "decode_steps", "engine_steps", "ttft_steps_sum",
                   "ttft_samples", "per_token_samples")


def _boundary_runs(models, mode):
    """The reference's paged and dense engines and the port's paged engine
    on ``BOUNDARY``."""
    jmodel, jparams, model, params = models
    kw = dict(BOUNDARY_KW, async_mode=MODES[mode])
    dense_kw = {k: v for k, v in kw.items() if k not in ("cache_kind", "block_size")}
    jdense, _, _ = _run(JEngine, JRequest, jmodel, jparams, BOUNDARY, 4, **dense_kw)
    jpaged = _run(JEngine, JRequest, jmodel, jparams, BOUNDARY, 4, **kw)
    return jdense, jpaged, _run(Engine, Request, model, params, BOUNDARY, 4, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_paged_boundary_packing_matches_reference(models, mode):
    """A budget that leaves room after a final chunk: the next prompt's
    head chunk rides the same dispatch in the second staging lane.  The
    newcomer's shared block is written only by that dispatch, so the port
    recomputes it (ROADMAP.md §3) where the reference reads it unwritten:
    the tokens are the reference's on the dense cache (the same schedule
    without shared blocks), the pool's bookkeeping the reference paged
    engine's, and its step clock the reference's but for one more chunk."""
    jdense, (_, jstats, jeng), (reqs, stats, eng) = _boundary_runs(models, mode)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jdense]
    assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
    assert eng.pool.in_use == 0 and eng.kv_bytes() == jeng.kv_bytes()
    a, b = dataclasses.asdict(stats), dataclasses.asdict(jstats)
    for k in RECOMPUTE_MOVES:
        del a[k], b[k]
    assert a == b
    assert stats.prefill_chunks == jstats.prefill_chunks + 1
    assert stats.boundary_packs >= 1


@pytest.mark.parametrize("mode", MODES)
def test_boundary_newcomer_does_not_read_unwritten_blocks(models, mode):
    """The fault the port repairs: the reference's paged engine matches the
    newcomer's first block, which request 0's chunk in the same dispatch
    has registered but not yet written, and reads it into the staging
    lane, so request 1 attends over the block's old contents (zeros here)
    and its tokens differ from the dense engine's.  The port begins
    request 1 at position 0 instead (its chunks, traced, show it)."""
    jmodel, jparams, model, params = models
    jdense, (jreqs, _, _), (reqs, _, eng) = _boundary_runs(models, mode)
    assert jreqs[1].out_tokens != jdense[1].out_tokens          # the reference's fault
    assert reqs[1].out_tokens == jdense[1].out_tokens
    tracer = Tracer(wall=False)
    traced = Engine(model, params, n_slots=2, max_seq=32, async_mode=MODES[mode],
                    tracer=tracer, **BOUNDARY_KW)
    for i, prompt in enumerate(BOUNDARY):
        traced.submit(Request(uid=i, prompt=prompt, max_new_tokens=4))
    traced.run()
    starts = [sp.attrs["pos"] for sp in tracer.spans if sp.name == "prefill_chunk" and sp.uid == 1]
    assert starts[0] == 0 and eng.pool.stats.hash_hits >= 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cache", CACHES)
def test_eos_on_hybrid_matches_reference(models, cache, mode):
    """An EOS id that the first request samples as its third token: async
    sees it one step late and masks the token dispatched past it, also
    when a chunk rides the same dispatch."""
    _, _, model, params = models
    kw = dict(**CACHES[cache], **SCHEDULES["hybrid"])
    ref, _, _ = _run(Engine, Request, model, params, MIXED, 6, async_mode=False, **kw)
    eos = ref[0].out_tokens[2]
    _same(models, MIXED, 6, eos_id=eos, async_mode=MODES[mode], **kw)


@pytest.mark.parametrize("mode", MODES)
def test_temperature_sampling_runs_on_paged_hybrid(models, mode):
    """Top-k temperature sampling on the paged hybrid path: every request
    completes with in-vocabulary tokens (distributions are compared by
    ``tests/test_torch_engine.py``'s sampler tests, not here)."""
    _, _, model, params = models
    reqs, stats, eng = _run(Engine, Request, model, params, MIXED, 5, async_mode=MODES[mode],
                            sampler=SamplerConfig(temperature=1.0, top_k=5),
                            cache_kind="paged", block_size=4, **SCHEDULES["hybrid"])
    assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
    assert all(0 <= t < model.cfg.vocab for r in reqs for t in r.out_tokens)
    assert stats.generated == 25 and eng.pool.in_use == 0


def _pick(lines, prefix):
    return next(line for line in lines if line.startswith(prefix))


@pytest.mark.parametrize("tier", [
    [],
    # int8 pool and a host tier on a pool that spills (12 blocks of 4 for 3 slots)
    ["--blocks", "12", "--kv-dtype", "int8", "--host-blocks", "16", "--max-new", "6"],
], ids=["bf16", "int8-host-tier"])
def test_serve_cli_paged_hybrid_prints_reference_lines(capsys, monkeypatch, tier):
    flags = ["--reduced", "--requests", "5", "--slots", "3", "--max-new", "4",
             "--max-seq", "32", "--workload-seed", "1", "--cache", "paged",
             "--block-size", "4", "--blocks", "16", "--schedule", "hybrid",
             "--prefill-chunk", "8", *tier]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    prefixes = ["mode:", "workload:", "requests=", "latency:", "pool:"]
    if tier:
        prefixes.append("kv tier:")
        assert "spills=0 " not in _pick(mine, "kv tier:")
    for prefix in prefixes:
        assert _pick(mine, prefix) == _pick(theirs, prefix), prefix


def test_serve_cli_accepts_tiered_kv_flags(capsys):
    """``--kv-dtype fp8|int8`` and ``--host-blocks`` serve to completion;
    the host tier adds the reference's ``kv tier:`` line."""
    for flag in (["--kv-dtype", "fp8"], ["--kv-dtype", "int8"], ["--host-blocks", "4"]):
        serve.main(["--reduced", "--device", "cpu", "--cache", "paged", "--requests", "3",
                    "--max-new", "3", *flag])
        out = capsys.readouterr().out
        assert "generated=9 " in out and "pool: PoolStats(" in out
        assert ("kv tier: spills=" in out) == (flag[0] == "--host-blocks"), flag
        if flag[0] == "--host-blocks":
            assert "/4 blocks" in _pick(out.splitlines(), "kv tier:")
