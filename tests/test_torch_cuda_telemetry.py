"""The serving observatory on the card: a profiled engine under CUDA
graphs never samples the dispatch that captures a graph, tracing and
profiling leave tokens, step clocks and kernel launches unchanged, and
the ``rag`` workload shares prefix blocks.  Every test here is marked
``cuda`` and skips (inside its fixture) where no GPU is visible.  This
file imports torch and the port only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_telemetry.py

Tolerances: none; tokens, stats and launch counts are compared exactly
(the same kernels on the same inputs, fences only add waits).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.telemetry import (DispatchProfiler, Tracer, build_request_trees,
                                           to_chrome_trace, validate_trace)
from repro_torch.serving.workload import WorkloadDriver, build_workload

pytestmark = pytest.mark.cuda

COMBOS = {
    "dense/decode-only": {},
    "paged/hybrid": dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8),
    "paged-fp8-host/hybrid": dict(cache_kind="paged", block_size=4, n_blocks=13, kv_dtype="fp8",
                                  host_blocks=8, schedule="hybrid", prefill_chunk=8),
    "dense-spec/hybrid": dict(spec_depth=2, schedule="hybrid", prefill_chunk=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler fences the card, graphs capture there")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    m = build_model(reduce_config("llama3.2-1b"), cuda)
    return m, m.init(3)


def _serve(m, params, kw, tracer=None, profiler=None):
    kw = dict(kw)
    if kw.get("spec_depth"):
        kw.update(draft_model=m, draft_params=params)
    eng = Engine(m, params, n_slots=3, max_seq=48, tracer=tracer, profiler=profiler, **kw)
    arrivals = build_workload("agentic", 3, vocab=m.cfg.vocab, max_seq=48, max_new=5, seed=2)
    drv = WorkloadDriver(eng, arrivals, vocab=m.cfg.vocab, max_seq=48, seed=2)
    ops.reset_launch_counts()
    drv.run()
    torch.cuda.synchronize()
    return drv, eng, ops.shape_counts()


@pytest.mark.parametrize("combo", COMBOS)
def test_traced_profiled_run_equals_plain_run(model, combo):
    m, params = model
    plain, plain_eng, plain_counts = _serve(m, params, COMBOS[combo])
    tracer, prof = Tracer(wall=True), DispatchProfiler(sample_every=1)
    drv, eng, counts = _serve(m, params, COMBOS[combo], tracer, prof)
    assert [r.out_tokens for r in drv.submitted] == [r.out_tokens for r in plain.submitted]
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(plain_eng.stats)
    assert counts == plain_counts and sum(sum(c.values()) for c in counts.values()) > 0
    assert eng.graphs and eng.capture_steps
    # every dispatch but the captures (and decode-only admissions) is timed
    sampled = {(s.kind, s.step) for s in prof.samples}
    assert not sampled & set(eng.capture_steps.items())
    dispatches = sum(eng.dispatch_counts.values())
    assert len(prof.samples) == dispatches - len(eng.capture_steps)
    assert all(s.seconds > 0 for s in prof.samples)
    obj = to_chrome_trace(tracer)
    assert validate_trace(obj) == []
    trees = build_request_trees(tracer)
    assert len(trees) == len(drv.submitted)
    assert all(t.finished and t.well_formed() == [] for t in trees.values())


def test_reduced_rag_serve_shares_prefixes(cuda):
    args = serve.build_parser().parse_args([
        "--reduced", "--device", "cuda", "--workload", "rag", "--requests", "12",
        "--cache", "paged", "--schedule", "hybrid", "--block-size", "8",
        "--slots", "4", "--max-seq", "64", "--max-new", "6", "--arrival-rate", "1.0"])
    model, params = serve.load_model(args)
    res = serve.serve(args, model, params)
    assert res.engine.graphs
    assert all(r.done for r in res.driver.submitted)
    assert res.engine.pool.stats.hash_hits > 0
    assert res.engine.pool.in_use == 0
