"""The port's per-kind programs (``serving/programs.py``) and what they
need of the model, against the JAX package: ``prefill_step`` at device
scalars (``slot`` / ``q_offset`` / ``n_valid`` as ``(1,)`` int32 tensors,
as the reference traces them) including chunks whose write window
crosses the end of the stripe, on the dense cache and on a staging lane;
the plain prefill at a tensor ``q_offset`` against the interpret-mode
Pallas kernel; the launch counters' capture-and-replay algebra;
``feed_token`` and ``Engine._hold_lengths`` at device slots; and the
engine, whose every dispatch runs through a program (eagerly on the
CPU, through the programs' static buffers), against the JAX engine:
{dense, paged} x {decode-only, hybrid} x {sync, async} and speculative
cases.  Inputs are made with numpy from seeds; weights are built by
``repro`` and carried across.

Tolerances: float32-mode logits 1e-4 and bf16 cache contents to one bf16
ulp (as ``tests/test_torch_paged.py``); attention f32 1e-5 (as
``tests/test_torch_kernels.py``); tokens, step stamps and stats exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.kernels import ops as jops
from repro.models.registry import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import LaunchCounter, ops
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged import device as pdev
from repro_torch.serving.programs import Program

# boundary packing with decodes in flight: fused, fused2, solo2 and decode
PACK = [np.random.default_rng(0).integers(1, 400, n).astype(np.int32)
        for n in (5, 3, 11, 4, 6, 2, 9, 3)]
SPEC_PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10, dtype=np.int32),
                np.arange(2, 13, dtype=np.int32), np.arange(4, 25, dtype=np.int32)]
SCHEDULES = {"decode-only": {}, "hybrid": dict(schedule="hybrid", prefill_chunk=8)}
CACHES = {"dense": {}, "paged": dict(cache_kind="paged", block_size=8)}
MODES = {"sync": False, "async": True}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dev(x: int) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_table_rows(monkeypatch):
    """The reference's paged async engine with its ``sync_slot`` race
    removed, as in ``tests/test_torch_hybrid.py``."""
    push = jdev.sync_slot

    def sync_slot(cache, slot, row, length=None):
        return push(cache, slot, np.array(row, np.int32), length)

    monkeypatch.setattr(jdev, "sync_slot", sync_slot)


@pytest.fixture(scope="module")
def models():
    """(JAX model, target params, draft params), the port's the same, in
    float32 mode; the draft is the target's config at seed 1."""
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jp, jd = jmodel.init(jax.random.key(0)), jmodel.init(jax.random.key(1))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    p, d = (params_from_numpy(jax.tree.map(np.asarray, x), "cpu") for x in (jp, jd))
    return (jmodel, jp, jd), (model, p, d)


# ------------------------------------------------ prefill_step at device scalars
@pytest.mark.parametrize("case", [
    # (rows, S, row, [(start, n_valid)]) at chunk 8: the dense cache's
    # slot 2, then staging lane 1 of max_blocks 3 x block 8; the last
    # chunk of each writes past the stripe (13 + 8 > 16, 21 + 8 > 24)
    (3, 16, 2, [(0, 8), (8, 5), (13, 3)]),
    (2, 24, 1, [(0, 8), (8, 8), (16, 5), (21, 2)]),
], ids=["dense-slot", "staging-lane"])
def test_prefill_step_device_scalars_match_reference(models, case):
    """Chunks at tensor ``slot`` / ``q_offset`` / ``n_valid``: logits,
    lengths and the whole cache equal the reference's ``prefill_step``
    (positions past the stripe dropped; within the window that crosses
    the end, positions below ``q_offset`` keep the earlier chunks' K/V);
    the host-int form gives the same bits."""
    (jmodel, jp, _), (model, p, _) = models
    rows, S, row, chunks = case
    rng = np.random.default_rng(21)
    prompt = rng.integers(1, model.cfg.vocab, size=S + 8).astype(np.int32)
    jcache = jmodel.init_cache(rows, S)
    init = rng.standard_normal(tuple(jcache["k"].shape), np.float32)
    jcache = {**jcache, "k": jnp.asarray(init, jnp.bfloat16), "v": jnp.asarray(-init, jnp.bfloat16)}
    cache, host = model.init_cache(rows, S), model.init_cache(rows, S)
    for c in (cache, host):
        c["k"].copy_(torch.from_numpy(init))
        c["v"].copy_(torch.from_numpy(-init))
    jstep = jax.jit(jmodel.prefill_step)
    for start, n_valid in chunks:
        tok = np.zeros((1, 8), np.int32)
        tok[0, :n_valid] = prompt[start:start + n_valid]
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok), np.int32(row), np.int32(start),
                                np.int32(n_valid))
        logits, _ = model.prefill_step(p, cache, torch.from_numpy(tok), _dev(row), _dev(start),
                                       _dev(n_valid))
        hlogits, _ = model.prefill_step(p, host, torch.from_numpy(tok), row, start, n_valid)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4,
                                   err_msg=f"chunk at {start}")
        assert torch.equal(logits, hlogits)
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), rtol=2**-7, atol=1e-6,
                                   err_msg=key)
        assert torch.equal(cache[key], host[key])


def test_prefill_step_refuses_a_chunk_wider_than_the_stripe(models):
    model, p, _ = models[1]
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill_step(p, model.init_cache(1, 4), torch.zeros(1, 8, dtype=torch.int32),
                           0, 0, 8)


@pytest.mark.parametrize("off", [0, 5, 17, 32])
def test_plain_prefill_tensor_q_offset_matches_pallas(off):
    """The plain prefill at a ``(1,)`` int32 ``q_offset`` equals the
    interpret-mode Pallas kernel at that offset (f32, 1e-5) and the
    host-int form bit for bit: a 16-row query block against 48 keys."""
    B, Sq, Sk, Hkv, G, D = 2, 16, 48, 2, 2, 16
    rng = np.random.default_rng(off)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, Sq, Hkv * G, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, q_offset=_dev(off))
    exp = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               q_offset=off, block_q=8, block_k=16)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)
    assert torch.equal(out, ops.flash_attention(tq, tk, tv, causal=True, q_offset=off))


# ------------------------------------------------------ launch-counter algebra
def test_launch_counter_delta_and_replay_algebra():
    """A capture's launches come off the counters and return once per
    replay, by kernel, variant and head shape; snapshots do not alias."""
    c = LaunchCounter("k")
    c.count("unscaled", "a")
    base = c.copy()
    c.count("unscaled", "a")
    c.count("fp8", "b")
    delta = c.minus(base)
    assert (delta.launches, delta.variants, delta.shapes) == (
        2, {"unscaled": 1, "fp8": 1}, {("unscaled", "a"): 1, ("fp8", "b"): 1})
    c.set_to(base)
    base.count("int8", "c")                       # the restored copy is its own
    assert (c.launches, c.variants, c.shapes) == (1, {"unscaled": 1}, {("unscaled", "a"): 1})
    for _ in range(3):
        c.add(delta)
    assert (c.launches, c.variants, c.shapes) == (
        7, {"unscaled": 4, "fp8": 3}, {("unscaled", "a"): 4, ("fp8", "b"): 3})
    assert c.minus(c.copy()) == LaunchCounter("k")     # nothing new: an empty delta

    ops.reset_launch_counts()
    try:
        kdec.COUNTER.count("unscaled", "Hkv2 G2 D16")
        snap = ops.snapshot_counts()
        kdec.COUNTER.count("unscaled", "Hkv8 G4 D64")    # what a capture would count
        kpaged.COUNTER.count("fp8", "Hkv8 G4 D64 bs16")
        kpaged.COUNTER.count("fp8", "Hkv8 G4 D64 bs16")
        delta = ops.counts_since(snap)
        ops.restore_counts(snap)
        assert ops.launch_counts() == {"decode_attention": 1, "prefill_attention": 0,
                                       "paged_decode_attention": 0, "flash_attention_bwd": 0}
        for _ in range(4):                               # four replays
            ops.add_counts(delta)
        assert ops.launch_counts() == {"decode_attention": 5, "prefill_attention": 0,
                                       "paged_decode_attention": 8, "flash_attention_bwd": 0}
        assert ops.variant_counts()["paged_decode_attention"] == {"fp8": 8}
        assert ops.shape_counts()["decode_attention"] == {
            ("unscaled", "Hkv2 G2 D16"): 1, ("unscaled", "Hkv8 G4 D64"): 4}
    finally:
        ops.reset_launch_counts()


# ------------------------------------------------- device-slot bookkeeping
def test_feed_token_at_device_slots():
    """``feed_token`` at a host int and at a ``(1,)`` device slot, and with
    the ``last`` flag of a program's chunk: 0 leaves the state as it was."""
    state = torch.arange(10, 14, dtype=torch.int32)
    pdev.feed_token(state, 1, torch.tensor([77], dtype=torch.int32))
    pdev.feed_token(state, _dev(3), torch.tensor([88]))
    pdev.feed_token(state, _dev(0), torch.tensor([99], dtype=torch.int32), when=_dev(0))
    pdev.feed_token(state, _dev(2), torch.tensor([55], dtype=torch.int32), when=_dev(1))
    pdev.feed_token(state, 0, torch.tensor([44], dtype=torch.int32), when=_dev(0))
    assert state.tolist() == [10, 77, 55, 88]


@pytest.mark.parametrize("cache", CACHES)
def test_hold_lengths_at_device_slots(models, cache):
    """The dense cache's mid-prefill slots go back to their chunk ends,
    read from the chunks' device scalars ``(slot, lane, start, n_valid,
    last)``; the paged pool's lengths are not the chunk's to hold."""
    model, p, _ = models[1]
    eng = Engine(model, p, n_slots=3, max_seq=32, schedule="hybrid", prefill_chunk=8,
                 **CACHES[cache])
    eng.cache["lengths"].copy_(torch.tensor([9, 9, 9], dtype=torch.int32))
    eng._hold_lengths([torch.tensor([2, 0, 8, 5, 0], dtype=torch.int32),
                       torch.tensor([0, 1, 0, 3, 1], dtype=torch.int32)])
    want = [3, 9, 13] if cache == "dense" else [9, 9, 9]
    assert eng.cache["lengths"].tolist() == want


# ------------------------------------------------------------------ programs
def test_program_runs_its_body_through_static_buffers():
    """A program copies a call's values into its static int32 buffer and
    runs the body on those views; graphs need a CUDA device."""
    seen = []

    def body(inp):
        seen.append({k: v.clone() for k, v in inp.items()})
        return (inp["tok0"].sum(dim=1) * inp["chunk0"][3:4],)

    prog = Program("solo", body, {"tok0": (1, 4), "chunk0": (5,)}, torch.device("cpu"))
    (out,) = prog(tok0=np.array([[1, 2, 3, 0]]), chunk0=(2, 1, 8, 3, 1))
    assert out.tolist() == [18] and prog.calls == 1 and prog.graph is None
    (out,) = prog(tok0=[[4, 0, 0, 0]], chunk0=[0, 0, 16, 1, 0])
    assert out.tolist() == [4]
    assert seen[0]["chunk0"].tolist() == [2, 1, 8, 3, 1] and seen[0]["tok0"].dtype == torch.int32
    assert prog.args.tolist() == [4, 0, 0, 0, 0, 0, 16, 1, 0]
    with pytest.raises(KeyError):
        prog(tok0=[[1, 2, 3, 4]])
    with pytest.raises(ValueError, match="CUDA"):
        Program("decode", body, {}, torch.device("cpu"), graphs=True)


def test_engine_graphs_need_a_cuda_device(models):
    model, p, _ = models[1]
    assert Engine(model, p, n_slots=2, max_seq=32).graphs is False
    with pytest.raises(ValueError, match="CUDA"):
        Engine(model, p, n_slots=2, max_seq=32, graphs=True)


def _run(engine_cls, request_cls, model, params, prompts, n_new, **kw):
    eng = engine_cls(model, params, n_slots=3, max_seq=32, **kw)
    reqs = [request_cls(uid=i, prompt=x, max_new_tokens=n_new) for i, x in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


def _same(models, prompts, n_new, **kw):
    """Both engines on one workload: tokens, step stamps, stats and pool
    stats equal; every dispatch ran through its kind's program, eagerly
    through the static buffers.  Returns the port's stats and engine."""
    (jmodel, jp, jd), (model, p, d) = models
    spec = dict(draft_model=jmodel, draft_params=jd) if kw.get("spec_depth") else {}
    jreqs, jstats, jeng = _run(JEngine, JRequest, jmodel, jp, prompts, n_new, **kw, **spec)
    spec = dict(draft_model=model, draft_params=d) if kw.get("spec_depth") else {}
    reqs, stats, eng = _run(Engine, Request, model, p, prompts, n_new, **kw, **spec)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    if kw.get("cache_kind") == "paged":
        assert dataclasses.asdict(eng.pool.stats) == dataclasses.asdict(jeng.pool.stats)
        assert eng.pool.in_use == 0
    for kind, n in eng.dispatch_counts.items():
        prog = eng.programs[kind]
        assert (prog.calls, prog.replays, prog.graph) == (n, 0, None), kind
    return stats, eng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cache", CACHES)
def test_programs_match_reference_engine(models, cache, schedule, mode):
    """Eight short prompts over three slots; on the hybrid schedule the
    boundary packing this forces runs ``fused2`` / ``solo2`` beside
    ``fused`` and ``decode``."""
    stats, eng = _same(models, PACK, 4, async_mode=MODES[mode], **CACHES[cache],
                       **SCHEDULES[schedule])
    want = {"decode"} | ({"fused", "solo2"} if schedule == "hybrid" else set())
    assert want <= set(eng.dispatch_counts)
    if schedule == "hybrid":
        assert stats.boundary_packs >= 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cache", CACHES)
def test_spec_programs_match_reference_engine(models, cache, mode):
    """Depth 2 on the hybrid schedule with a mismatched draft: ``spec``,
    ``spec_fused``, ``solo`` and the draft's chunk prefill, one program
    call per draft chunk."""
    stats, eng = _same(models, SPEC_PROMPTS, 5, spec_depth=2, async_mode=MODES[mode],
                       **CACHES[cache], **SCHEDULES["hybrid"])
    assert {"spec", "spec_fused", "solo"} <= set(eng.dispatch_counts)
    assert eng.programs["draft_prefill"].calls == stats.draft_steps - 3 * stats.spec_steps > 0
