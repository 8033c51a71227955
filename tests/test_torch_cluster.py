"""The port's cluster tier against the JAX package's, the counterpart of
``tests/test_cluster.py``: the router's ranking for the three policies,
spill-over, saturation and tie-breaks (duck-typed replicas), the
side-effect-free prefix probe and the admission shortfall, and 2-replica
clusters of the port against the JAX cluster in float32 mode (f32 weights
and activations, bf16 KV; the same weights carried across as numpy) over
{dense, paged} x {decode-only, hybrid} x {sync, async}.  Per-request
greedy tokens and step stamps, ``ClusterStats`` (tokens per round, the
round-clock TTFT samples, queue wait, load imbalance, every replica's
routed and generated counts and ``EngineStats``), ``RouterStats``,
``PoolStats``, the ``cluster_registry`` snapshot and the dashboard's
cluster rows must be equal: the round and step clocks do not depend on
the machine, so any difference is a fault, not noise.

The reference's paged async engine runs with one race removed
(``_copied_table_rows``, as in ``tests/test_torch_hybrid.py``): its
``device.sync_slot`` pushes ``manager.tables[slot]`` through
``jnp.asarray``, which on the CPU may alias the numpy row that the
manager rewrites in place before the push has run.  The test hands it a
copy of the row, which is what its code means.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.models.registry import build_model as jbuild_model
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro.serving.telemetry import cluster_registry as jcluster_registry
from repro.serving.telemetry import render_dashboard as jrender_dashboard
from repro_torch.configs.reduced import reduce_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving.cluster import ROUTE_POLICIES, Cluster, Router
from repro_torch.serving.engine import Engine, EngineLoad, Request
from repro_torch.serving.paged.block_pool import BlockPool
from repro_torch.serving.paged.manager import PagedCacheManager
from repro_torch.serving.telemetry import cluster_registry, render_dashboard

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(7, 10, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),      # shared prefix (paged)
           np.arange(4, 25, dtype=np.int32)]      # multi-chunk

CACHES = {"dense": {}, "paged": dict(cache_kind="paged", block_size=8)}
SCHEDULES = {"decode-only": {}, "hybrid": dict(schedule="hybrid", prefill_chunk=8)}
MODES = {"sync": False, "async": True}
# the dense cache has no prefix to probe: rank it by load; the paged
# pool by resident prefix
ROUTES = {"dense": "least_loaded", "paged": "prefix_affinity"}


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


def _serve(cluster_cls, request_cls, model, params, prompts, n_new=5, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 32)
    cl = cluster_cls(model, params, 2, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        cl.submit(r)
    return reqs, cl.run(), cl


def same_cluster(models, prompts, n_new=5, **kw):
    """The port's and the JAX cluster on one workload; everything
    observable must agree.  Returns the port's requests, stats, cluster."""
    jmodel, jparams, model, params = models
    jreqs, jstats, jcl = _serve(JCluster, JRequest, jmodel, jparams, prompts, n_new, **kw)
    reqs, stats, cl = _serve(Cluster, Request, model, params, prompts, n_new, **kw)
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0 and r.in_flight_steps == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert dataclasses.asdict(cl.router.stats) == dataclasses.asdict(jcl.router.stats)
    assert cl.placement == jcl.placement
    for attr in ("tokens_per_round", "mean_ttft_rounds", "mean_queue_wait_rounds",
                 "load_imbalance", "prefix_hit_rate", "mean_ttft_steps", "generated"):
        assert getattr(stats, attr) == getattr(jstats, attr), attr
    assert stats.summary() == jstats.summary()
    # the reporting views: the metrics registry and the dashboard's rows
    assert cluster_registry(stats).snapshot() == jcluster_registry(jstats).snapshot()
    assert render_dashboard(cl, cl.rounds) == jrender_dashboard(jcl, jcl.rounds)
    for e, je in zip(cl.engines, jcl.engines):
        if e.cache_kind == "paged":
            assert dataclasses.asdict(e.pool.stats) == dataclasses.asdict(je.pool.stats)
            assert e.pool.in_use == 0
    return reqs, stats, cl


# ------------------------------------------------------------ fake replicas
class FakeEngine:
    """Duck-typed replica for pure router tests."""

    def __init__(self, admit=True, inflight=0, free_blocks=None, free_slots=1, prefix_hit=0):
        self.admit = admit
        self.inflight = inflight
        self.free_blocks = free_blocks
        self.free_slots = free_slots
        self.prefix_hit = prefix_hit

    def can_admit(self, req):
        return self.admit

    def load(self):
        return EngineLoad(free_slots=self.free_slots, queued=0,
                          inflight_tokens=self.inflight, free_blocks=self.free_blocks)

    def probe_prefix(self, prompt):
        return self.prefix_hit

    def submit(self, req):
        self.inflight += len(req.prompt)


def _req(n=4, uid=0):
    return Request(uid=uid, prompt=np.arange(1, n + 1, dtype=np.int32), max_new_tokens=2)


# ------------------------------------------------------------------- router
def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        Router([FakeEngine()], "fastest")
    with pytest.raises(ValueError):
        Router([], "round_robin")


def test_router_round_robin_cycles():
    router = Router([FakeEngine(), FakeEngine(), FakeEngine()], "round_robin")
    assert [router.route(_req(uid=i)) for i in range(6)] == [0, 1, 2, 0, 1, 2]
    assert router.stats.routed == [2, 2, 2]
    assert router.stats.spills == 0 and router.stats.total_routed == 6


def test_router_spills_over_saturated_replica():
    router = Router([FakeEngine(admit=False), FakeEngine()], "round_robin")
    assert router.route(_req(uid=0)) == 1          # 0 full -> spill to 1
    assert router.stats.spills == 1 and router.stats.routed == [0, 1]


@pytest.mark.parametrize("policy", ROUTE_POLICIES)
def test_router_returns_none_when_all_saturated(policy):
    router = Router([FakeEngine(admit=False), FakeEngine(admit=False)], policy)
    assert router.route(_req()) is None
    assert router.stats.total_routed == 0          # nothing counted


def test_router_least_loaded_levels_load():
    """Each placement goes to the lightest replica, so loads level out."""
    engines = [FakeEngine(inflight=9), FakeEngine(inflight=0), FakeEngine(inflight=5)]
    router = Router(engines, "least_loaded")
    for i in range(8):
        idx = router.route(_req(n=4, uid=i))
        assert engines[idx].inflight == min(e.inflight for e in engines)
        engines[idx].submit(_req(n=4, uid=100 + i))
    assert max(e.inflight for e in engines) - min(e.inflight for e in engines) <= 4


def test_router_least_loaded_tiebreaks():
    """Equal in-flight tokens: more free blocks first, then more free
    slots, then the lower index."""
    blocks = Router([FakeEngine(inflight=4, free_blocks=1),
                     FakeEngine(inflight=4, free_blocks=7)], "least_loaded")
    assert blocks.rank(_req()) == [1, 0]
    slots = Router([FakeEngine(inflight=4, free_slots=1),
                    FakeEngine(inflight=4, free_slots=3)], "least_loaded")
    assert slots.rank(_req()) == [1, 0]
    index = Router([FakeEngine(inflight=4), FakeEngine(inflight=4)], "least_loaded")
    assert index.rank(_req()) == [0, 1]


def test_router_prefix_affinity_prefers_hit_then_load():
    router = Router([FakeEngine(inflight=0, prefix_hit=0),
                     FakeEngine(inflight=99, prefix_hit=16),
                     FakeEngine(inflight=1, prefix_hit=16)], "prefix_affinity")
    assert router.rank(_req()) == [2, 1, 0]
    assert router.route(_req(n=4)) == 2
    assert router.stats.prefix_hit_tokens == 16 and router.stats.probed_tokens == 4
    assert router.stats.prefix_hit_rate == 4.0


# ----------------------------------------------------------- probe_prefix
def test_probe_prefix_is_side_effect_free():
    pool = BlockPool(n_blocks=16, block_size=4)
    mgr = PagedCacheManager(pool, n_slots=2, max_blocks=4)
    prompt = np.arange(1, 11, dtype=np.int32)      # 10 tokens = 2.5 blocks
    assert mgr.try_admit(0, prompt) is not None
    before = (copy.deepcopy(pool._ref), copy.deepcopy(pool._key_to_block),
              pool.free_count, tuple(vars(pool.stats).items()))
    assert mgr.probe_prefix(prompt) == 10          # whole prompt resident
    assert mgr.probe_prefix(prompt[:8]) == 8       # full-block prefix
    assert mgr.probe_prefix(np.arange(50, 60, dtype=np.int32)) == 0
    assert (pool._ref, pool._key_to_block, pool.free_count,
            tuple(vars(pool.stats).items())) == before


def test_admit_shortfall_matches_admission():
    pool = BlockPool(n_blocks=16, block_size=4)
    mgr = PagedCacheManager(pool, n_slots=2, max_blocks=4)
    first = np.arange(1, 9, dtype=np.int32)        # 2 blocks exactly
    assert mgr.admit_shortfall(first) == 3         # + 1 decode headroom
    free = pool.free_count
    mgr.try_admit(0, first)
    assert free - pool.free_count == 3             # what admission took
    assert mgr.admit_shortfall(first) == 1         # resident prefix: headroom only
    second = np.concatenate([first[:4], np.arange(90, 93, dtype=np.int32)])
    assert mgr.admit_shortfall(second) == 1        # one shared block, one fresh
    free = pool.free_count
    mgr.try_admit(1, second)
    assert free - pool.free_count == 1


def test_engine_hooks_are_read_only(models):
    """``load``, ``can_admit`` and ``probe_prefix`` of a live paged engine
    change nothing, and agree with what admission then does."""
    _, _, model, params = models
    eng = Engine(model, params, n_slots=2, max_seq=32, cache_kind="paged", block_size=4,
                 async_mode=False)
    first = Request(uid=0, prompt=np.arange(2, 14, dtype=np.int32), max_new_tokens=4)
    eng.submit(first)
    eng.step()
    probe = Request(uid=1, prompt=np.arange(2, 14, dtype=np.int32), max_new_tokens=4)
    state = (copy.deepcopy(eng.pool._ref), eng.pool.free_count,
             tuple(vars(eng.pool.stats).items()))
    # the prompt and two tokens: the prefill's and one decode step's
    assert eng.load() == EngineLoad(free_slots=1, queued=0, inflight_tokens=12 + 2,
                                    free_blocks=eng.pool.free_count)
    assert eng.probe_prefix(probe.prompt) == 12
    assert eng.can_admit(probe)
    assert (copy.deepcopy(eng.pool._ref), eng.pool.free_count,
            tuple(vars(eng.pool.stats).items())) == state
    eng.submit(probe)
    assert not eng.can_admit(_req(uid=2))          # something is queued here
    hits = eng.pool.stats.hash_hits
    eng.step()
    assert eng.slots.count(None) == 0 and eng.pool.stats.hash_hits > hits


# ------------------------------------------------------ cluster equivalence
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cache", CACHES)
def test_cluster_matches_reference(models, cache, schedule, mode):
    reqs, stats, cl = same_cluster(models, PROMPTS, route=ROUTES[cache],
                                   async_mode=MODES[mode], **CACHES[cache],
                                   **SCHEDULES[schedule])
    assert stats.generated == sum(len(r.out_tokens) for r in reqs)
    assert sum(s.routed for s in stats.replicas) == len(PROMPTS)
    assert all(s.engine.generated > 0 for s in stats.replicas)     # both replicas served
    assert sorted(cl.placement) == [r.uid for r in reqs] and not cl.queue
    assert len(stats.ttft_rounds_samples) == len(PROMPTS)


@pytest.mark.parametrize("cache", CACHES)
def test_cluster_matches_single_engine(models, cache):
    """Routing moves requests, never changes them: every policy's 2-replica
    cluster gives each request the single engine's greedy tokens."""
    _, _, model, params = models
    kw = dict(CACHES[cache], **SCHEDULES["hybrid"])
    eng = Engine(model, params, n_slots=2, max_seq=32, **kw)
    single = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(PROMPTS)]
    for r in single:
        eng.submit(r)
    eng.run()
    for route in ROUTE_POLICIES:
        reqs, _, _ = _serve(Cluster, Request, model, params, PROMPTS, route=route, **kw)
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in single], route


def test_cluster_rejects_oversized_prompt_and_duplicate_uid(models):
    jmodel, jparams, model, params = models
    for cls, req_cls, m, p in ((Cluster, Request, model, params),
                               (JCluster, JRequest, jmodel, jparams)):
        cl = cls(m, p, 2, n_slots=2, max_seq=32)
        with pytest.raises(ValueError, match="does not fit max_seq"):
            cl.submit(req_cls(uid=0, prompt=np.arange(40, dtype=np.int32), max_new_tokens=2))
        cl.submit(req_cls(uid=7, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2))
        with pytest.raises(ValueError, match="duplicate request uid 7"):
            cl.submit(req_cls(uid=7, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="need >= 1 replica"):
        Cluster(model, params, 0, n_slots=2, max_seq=32)


def test_cluster_prefix_affinity_beats_round_robin(models):
    """Interleaved shared-prefix groups: affinity routing lands group
    members where their blocks live, round robin does not; both clusters
    equal the JAX clusters, hit rates included."""
    rng = np.random.default_rng(2)
    vocab = models[2].cfg.vocab
    prefixes = [rng.integers(1, vocab, size=16).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([prefixes[g], rng.integers(1, vocab, size=3).astype(np.int32)])
               for _ in range(3) for g in range(3)]
    kw = dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8, n_slots=4)
    _, rr, _ = same_cluster(models, prompts, 10, route="round_robin", **kw)
    _, aff, _ = same_cluster(models, prompts, 10, route="prefix_affinity", **kw)
    assert aff.prefix_hit_rate > rr.prefix_hit_rate
