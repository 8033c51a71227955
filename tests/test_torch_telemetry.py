"""The port's serving observatory against the JAX package's, in float32
mode (f32 weights and activations, bf16 KV) with the same weights
carried across as numpy.

Over {dense, paged} x {decode-only, hybrid} x {sync, async}, plus a
tiered (fp8 pool, host tier) and a speculative case, a traced run of the
port must give the reference engine's Perfetto trace as JSON
(``Tracer(wall=False)``: no wall stamps), its ``StepRecord`` list (wall
and measured fields aside), its ``engine_registry`` snapshot and its
``SLOMonitor`` attainment and goodput, exactly: every number is Python
arithmetic on the step clock's ints.  Tracing must leave tokens and
``EngineStats`` unchanged.  The pure modules (cost model, roofline
helpers, metrics, SLO replay, export, dashboard, cluster hooks) are held
equal on the same inputs, and the profiler takes the reference's samples
on the CPU, where no dispatch captures a graph.

The reference engine runs with its ``sync_slot`` / ``sync_host_slot``
races removed (rows handed over as copies; see
``tests/test_torch_hybrid.py``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.configs import get_config as jget_config
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core import balance as jbalance
from repro.core import oi as joi
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving import telemetry as jtel
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.analysis import roofline
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import balance, oi
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import telemetry as tel
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.telemetry.timeline import chunk_bucket

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(7, 10, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),                # a shared prefix
           np.arange(4, 25, dtype=np.int32)]                # multi-chunk
HYBRID = dict(schedule="hybrid", prefill_chunk=8)
PAGED = dict(cache_kind="paged", block_size=8)
CASES = {
    "dense/decode-only": {},
    "dense/hybrid": HYBRID,
    "paged/decode-only": PAGED,
    "paged/hybrid": {**PAGED, **HYBRID},
    # 12 usable blocks of 4: the pool spills to the host tier
    "paged-tiered/hybrid": dict(cache_kind="paged", block_size=4, n_blocks=13,
                                kv_dtype="fp8", host_blocks=8, **HYBRID),
    "paged-spec/hybrid": dict(spec_depth=2, draft="same", **PAGED, **HYBRID),
}
CASE_MODES = [(c, m) for c in CASES for m in ("sync", "async")
              if c in ("dense/decode-only", "dense/hybrid", "paged/decode-only",
                       "paged/hybrid") or m == "async"]
SLO = dict(ttft_target=6, tpot_target=1.2)
TIMING = ("wall", "measured_s", "measured_mfu", "measured_mbu", "achieved_gbps")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _copied_rows(monkeypatch):
    push, push_host = jdev.sync_slot, jdev.sync_host_slot

    def sync_slot(cache, slot, row, length=None):
        return push(cache, slot, np.array(row, np.int32), length)

    def sync_host_slot(cache, slot, row, cold_len):
        return push_host(cache, slot, np.array(row, np.int32), cold_len)

    monkeypatch.setattr(jdev, "sync_slot", sync_slot)
    monkeypatch.setattr(jdev, "sync_host_slot", sync_host_slot)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def _run(engine_cls, request_cls, model, params, kw, tracer=None, profiler=None, n_new=5):
    kw = dict(kw)
    if kw.pop("draft", None):
        kw.update(draft_model=model, draft_params=params)
    eng = engine_cls(model, params, n_slots=2, max_seq=32, tracer=tracer, profiler=profiler,
                     **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng


def _pool(eng):
    return eng.pool.stats if eng.cache_kind == "paged" else None


def _records(tracer):
    return [{k: v for k, v in dataclasses.asdict(r).items() if k not in TIMING}
            for r in tracer.steps]


@pytest.mark.parametrize("case,mode", CASE_MODES)
def test_traced_run_matches_reference(models, case, mode):
    jmodel, jparams, model, params = models
    kw = dict(CASES[case], async_mode=mode == "async")
    jslo, slo = jtel.SLOMonitor(**SLO), tel.SLOMonitor(**SLO)
    jtracer, tracer = jtel.Tracer(wall=False, slo=jslo), tel.Tracer(wall=False, slo=slo)
    jreqs, jeng = _run(JEngine, JRequest, jmodel, jparams, kw, jtracer)
    reqs, eng = _run(Engine, Request, model, params, kw, tracer)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)

    ours = json.dumps(tel.to_chrome_trace(tracer), sort_keys=True)
    ref = json.dumps(jtel.to_chrome_trace(jtracer), sort_keys=True)
    assert ours == ref
    assert tel.validate_trace(json.loads(ours)) == []
    assert _records(tracer) == _records(jtracer)
    assert len(tracer.steps) >= eng.stats.engine_steps - eng.stats.prefills
    trees = tel.build_request_trees(tracer)
    assert len(trees) == len(PROMPTS)
    assert all(t.finished and t.well_formed() == [] for t in trees.values())

    reg = tel.engine_registry(eng.stats, _pool(eng))
    jreg = jtel.engine_registry(jeng.stats, _pool(jeng))
    slo.register(reg, elapsed=eng.stats.engine_steps)
    jslo.register(jreg, elapsed=jeng.stats.engine_steps)
    assert reg.snapshot() == jreg.snapshot()
    assert (slo.attainment, slo.goodput(eng.stats.engine_steps), slo.describe()) == \
        (jslo.attainment, jslo.goodput(jeng.stats.engine_steps), jslo.describe())
    assert tel.render_dashboard(eng, 3, slo=slo) == jtel.render_dashboard(jeng, 3, slo=jslo)
    if case.startswith("paged-tiered"):
        assert eng.stats.spills > 0
    if "spec" in case:
        assert any(e.name == "spec_verify" for e in tracer.events)

    # tracing changes nothing the run computes
    plain, plain_eng = _run(Engine, Request, model, params, kw)
    assert [r.out_tokens for r in plain] == [r.out_tokens for r in reqs]
    assert dataclasses.asdict(plain_eng.stats) == dataclasses.asdict(eng.stats)
    assert plain_eng._telemetry is False and plain_eng._cost_model is None
    assert plain_eng.tracer is tel.NULL_TRACER and plain_eng.profiler is tel.NULL_PROFILER


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("case", ["dense/decode-only", "paged/hybrid", "paged-spec/hybrid"])
def test_profiler_samples_the_reference_dispatches(models, case, every):
    """On the CPU nothing captures a graph, so the profiler fences the
    reference engine's dispatches: the same count, steps, kinds and
    analytic costs."""
    jmodel, jparams, model, params = models
    kw = dict(CASES[case], async_mode=True)
    jprof = jtel.DispatchProfiler(sample_every=every)
    prof = tel.DispatchProfiler(sample_every=every)
    jreqs, _ = _run(JEngine, JRequest, jmodel, jparams, kw, profiler=jprof)
    reqs, eng = _run(Engine, Request, model, params, kw, profiler=prof)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    keys = ("replica", "step", "kind", "bucket", "decode_batch", "flops", "bytes", "oi")

    def analytic(samples):
        return [tuple(getattr(s, k) for k in keys) for s in samples]

    assert len(prof.samples) > 0 and analytic(prof.samples) == analytic(jprof.samples)
    assert eng.capture_steps == {}
    peak = oi.DEVICES["H100-SXM"]
    for s in prof.samples:
        assert s.seconds > 0
        assert s.measured_mbu == pytest.approx(s.bytes / (s.seconds * peak.bw))
        assert s.measured_mfu == pytest.approx(s.flops / (s.seconds * peak.flops))
    reg = tel.MetricsRegistry()
    prof.register(reg)
    assert reg.snapshot()["profiled_dispatches"] == len(prof.samples)


def test_profile_devices():
    assert oi.DEVICES["H100-SXM"] == oi.Device("H100-SXM", 3.35e12, 989e12, 80e9, 700.0, 900e9)
    assert {k: v for k, v in oi.DEVICES.items() if k != "H100-SXM"} == \
        {k: oi.Device(*dataclasses.astuple(v)) for k, v in joi.DEVICES.items()}
    assert tel.DispatchProfiler().device.name == "H100-SXM"
    assert tel.make_profiler(0) is tel.NULL_PROFILER
    for bad in ("H100", "TPU-V6"):
        with pytest.raises(ValueError, match="unknown profile device"):
            tel.DispatchProfiler(device=bad)
        with pytest.raises(ValueError):
            tel.make_profiler(4, device=bad)
    with pytest.raises(ValueError):
        tel.DispatchProfiler(sample_every=0)


def _cfgs():
    return [(reduce_config("llama3.2-1b"), jreduce_config("llama3.2-1b")),
            (get_config("llama3.2-1b"), jget_config("llama3.2-1b"))]


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_cost_model_matches_reference(which):
    cfg, jcfg = _cfgs()[which == "full"]
    assert balance._active_params(cfg) == jbalance._active_params(jcfg)
    assert balance.kv_bytes_per_seq(cfg, 1000) == jbalance.kv_bytes_per_seq(jcfg, 1000)
    for args in [(16, 8115), (0, 0, 509, 129795), (3, 700, 32, 6656, 1e6), (1, 1)]:
        assert roofline.dispatch_flops_bytes(cfg, *args) == \
            jroofline.dispatch_flops_bytes(jcfg, *args)
    cm, jcm = tel.DispatchCostModel(cfg), jtel.DispatchCostModel(jcfg)
    assert cm.cost(4, 900, 32, 6656) == jcm.cost(4, 900, 32, 6656)
    assert cm.chunk_ctx_tokens(192, 32) == jcm.chunk_ctx_tokens(192, 32)
    # the MoE family counts its top-k and shared experts, as the reference
    moe, jmoe = ((reduce_config("moonshot-v1-16b-a3b"), jreduce_config("moonshot-v1-16b-a3b"))
                 if which == "reduced" else
                 (get_config("moonshot-v1-16b-a3b"), jget_config("moonshot-v1-16b-a3b")))
    assert balance._active_params(moe) == jbalance._active_params(jmoe)
    assert roofline.dispatch_flops_bytes(moe, 16, 8115) == \
        jroofline.dispatch_flops_bytes(jmoe, 16, 8115)
    # the recurrent families and the encoder-decoder, as the reference counts
    # them (the recurrent state once per attended position: ROADMAP §3)
    for arch in ("rwkv6-7b", "zamba2-1.2b", "seamless-m4t-medium"):
        c, jc = ((reduce_config(arch), jreduce_config(arch)) if which == "reduced" else
                 (get_config(arch), jget_config(arch)))
        assert balance._active_params(c) == jbalance._active_params(jc), arch
        for seq in (1, 1000):
            assert balance.kv_bytes_per_seq(c, seq) == jbalance.kv_bytes_per_seq(jc, seq), arch
        for args in [(16, 8115), (0, 0, 509, 129795), (3, 700, 32, 6656, 1e6)]:
            assert roofline.dispatch_flops_bytes(c, *args) == \
                jroofline.dispatch_flops_bytes(jc, *args), arch


def test_roofline_helpers_match_reference():
    m = joi.LLAMA2_7B
    shape = oi.LMShape(*dataclasses.astuple(m))
    for name, dev in joi.DEVICES.items():
        d = oi.DEVICES[name]
        for b in (1, 16, 256):
            assert oi.mfu_mbu(d, oi.gemm_oi(b)) == joi.mfu_mbu(dev, joi.gemm_oi(b))
            assert oi.step_time_gpu_only(d, shape, b, 2048) == \
                joi.step_time_gpu_only(dev, m, b, 2048)
        assert oi.max_batch_gpu_only(d, shape, 4096) == joi.max_batch_gpu_only(dev, m, 4096)
    h = oi.DEVICES["HPU"]
    t = oi.step_time_hetero(oi.DEVICES["A100"], h, shape, 64, 2048)
    assert t == joi.step_time_hetero(joi.DEVICES["A100"], joi.DEVICES["HPU"], m, 64, 2048)
    assert oi.tokens_per_joule(64, t, oi.DEVICES["A100"], 4) == \
        joi.tokens_per_joule(64, t, joi.DEVICES["A100"], 4)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_metrics_primitives_match_reference(n):
    rng = np.random.default_rng(n)
    xs = rng.integers(0, 50, n).tolist()
    for p in (-5, 0, 1, 50, 90, 99, 100, 150):
        assert tel.percentile(xs, p) == jtel.percentile(xs, p)
    reg, jreg = tel.MetricsRegistry(), jtel.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("c").inc(n)
        r.gauge("g").set(n / 3)
        r.histogram("h").extend(xs)
    assert reg.snapshot() == jreg.snapshot() and reg.render("x_") == jreg.render("x_")
    with pytest.raises(TypeError):
        reg.gauge("c")


def _span(mod, uid, name, start, end, generated=None):
    attrs = {} if generated is None else {"generated": generated}
    return mod.Span(replica=0, track=0, uid=uid, name=name, start=start, end=end, attrs=attrs)


def test_slo_replay_matches_reference():
    def spans(mod):
        return [_span(mod, 0, "queued", 0, 2), _span(mod, 0, "decode", 3, 9, 5),
                _span(mod, 1, "queued", 1, 9), _span(mod, 1, "decode", 12, 14, 3),
                _span(mod, 2, "queued", 0, 1), _span(mod, 2, "decode", 2, 4, 2),
                _span(mod, 2, "queued", 4, 6), _span(mod, 2, "decode", 7, 20, 4),
                _span(mod, 3, "queued", 0, 3)]
    for targets in [dict(ttft_target=4, tpot_target=1.5), {}, dict(tpot_target=1.0)]:
        ours = tel.SLOMonitor.from_spans(spans(tel), **targets, window=2)
        ref = jtel.SLOMonitor.from_spans(spans(jtel), **targets, window=2)
        reg, jreg = tel.MetricsRegistry(), jtel.MetricsRegistry()
        ours.register(reg, elapsed=20)
        ref.register(jreg, elapsed=20)
        assert reg.snapshot() == jreg.snapshot() and ours.describe() == ref.describe()


class _Req:
    def __init__(self, uid, prompt_len, n_out, submit_step=0):
        self.uid, self.prompt = uid, np.zeros(prompt_len, np.int32)
        self.out_tokens, self.submit_step = [1] * n_out, submit_step
        self.first_token_step = 3


def _cluster_calls(mod):
    """The same synthetic cluster history through one tracer: routing,
    a prefill -> decode migration, a refold moved off its home replica."""
    t = mod.Tracer(wall=False, slo=mod.SLOMonitor(ttft_target=2))
    a, b = _Req(0, 9, 4), _Req(1, 5, 2, submit_step=1)
    t.round = 1
    t.on_route(0, 0, "prefix_affinity", 0, 8, 16)
    t.on_submit(0, a, 0)
    t.on_admit(0, a, 0, 0, n_tokens=9)
    t.on_chunk(0, a, 0, 0, 1, 0, 8, 8, False)
    t.on_chunk(0, a, 0, 1, 2, 8, 1, 8, True)
    t.on_first_token(0, a, 2, 0)
    t.round = 2
    t.on_migrate(a, 0, 2, 0, 1, 5, 3, n_blocks=2)
    t.on_route(1, 1, "least_loaded", 1, 0, 5)
    t.on_submit(1, b, 1)
    t.on_admit(1, b, 2, 1, n_tokens=5)
    t.on_chunk(1, b, 1, 2, 3, 0, 5, 8, True)
    t.on_first_token(1, b, 3, 1)
    t.on_preempt(1, b, 4, 1)
    t.round = 3
    t.on_refold_move(b, 1, 0)
    t.on_spill(1, 5, 3, 0)
    t.on_rehydrate(0, 6, 0, 4)
    t.on_finish(1, a, 9, 3)
    return t


def test_cluster_hooks_match_reference():
    t, jt = _cluster_calls(tel), _cluster_calls(jtel)
    obj = tel.to_chrome_trace(t)
    assert json.dumps(obj, sort_keys=True) == json.dumps(jtel.to_chrome_trace(jt), sort_keys=True)
    assert tel.validate_trace(obj) == []
    assert t.replicas() == jt.replicas() == [0, 1]
    trees, jtrees = tel.build_request_trees(t), jtel.build_request_trees(jt)
    assert sorted(trees) == sorted(jtrees)
    for key, tree in trees.items():
        assert tree.well_formed() == jtrees[key].well_formed()
        assert [e.name for e in tree.events] == [e.name for e in jtrees[key].events]
    assert any(e["name"] == "kv_migrate" for e in obj["traceEvents"])


def test_validate_trace_rejects_like_the_reference():
    bad = [None, {}, {"traceEvents": 3},
           {"traceEvents": [{"ph": "Q", "name": "", "pid": "0", "tid": 0, "ts": -1}]},
           {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": 0}]},
           {"traceEvents": [{"ph": "C", "name": "c", "pid": 0, "tid": 0, "ts": 0}]}]
    for obj in bad:
        assert tel.validate_trace(obj) == jtel.validate_trace(obj) != []


def test_write_trace_and_metrics_round_trip(models, tmp_path):
    _, _, model, params = models
    tracer = tel.Tracer(wall=True)
    _, eng = _run(Engine, Request, model, params, dict(CASES["paged/hybrid"], async_mode=True),
                  tracer)
    path = tel.write_trace(tracer, tmp_path / "t.json")
    obj = json.loads(path.read_text())
    assert tel.validate_trace(obj) == [] and obj["otherData"]["clock"] == "engine_steps"
    assert all(r.wall is not None for r in tracer.steps)
    reg = tel.engine_registry(eng.stats, eng.pool.stats)
    out = json.loads(tel.write_metrics(reg, tmp_path / "m.json", extra={"x": 1.5}).read_text())
    assert out == {**reg.snapshot(), "x": 1.5}
    tracer.spans.append(tel.Span(replica=0, track=0, uid=9, name="decode", start=3, end=1))
    tracer.steps[0].step = -5              # a negative timestamp: invalid
    with pytest.raises(ValueError, match="invalid trace"):
        tel.write_trace(tracer, tmp_path / "bad.json")


@pytest.mark.parametrize("n", [1, 3, 5, 8, 9, 17, 32])
def test_chunk_bucket_is_the_reference_bucket(n):
    from repro.serving.scheduler import Scheduler as JScheduler
    for chunk in (8, 32, 33):
        if n <= chunk:
            sched = JScheduler(n_slots=2, max_seq=64, mode="hybrid", prefill_chunk=chunk)
            assert chunk_bucket(chunk, n) == sched.pick_bucket(n)
