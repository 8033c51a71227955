"""Disaggregated prefill/decode serving in the port against the JAX
package, the counterpart of ``tests/test_disagg.py``: role parsing and
the router's role filtering; 1P+1D clusters of the port against the JAX
cluster in float32 mode (f32 weights and activations, bf16 KV; the same
weights carried across as numpy) across cache, schedule and mode, tokens,
migrations and ``ClusterStats`` equal, and the trace JSON with its
``kv_migrate`` marks equal; the KV block-migration edge cases
(a shared-prefix export leaves the source's blocks and hash entries
intact, an import into a full pool spills to the host tier instead of
preempting, the block gather and scatter byte-equal to the reference's
on bf16, fp8 and int8 pools with their scale tiles, an engine's fp8/int8
payload equal to the reference engine's and landed bit-exactly, a dtype
mismatch refuses, a refold
move reproduces the decode, an import under speculation re-prefills the
draft); and the serve CLI's cluster lines against the reference CLI's.

The reference's paged async engine runs with copied table rows
(``_copied_table_rows``, as in ``tests/test_torch_hybrid.py``): its
``device.sync_slot`` may push an aliased numpy row that the manager
rewrites before the push has run.
"""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild_model
from repro.serving import telemetry as jtel
from repro.serving.cluster import Cluster as JCluster
from repro.serving.cluster import parse_roles as jparse_roles
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.paged import device as jdev
from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import telemetry as tel
from repro_torch.serving.cluster import Cluster, Router, parse_roles
from repro_torch.serving.engine import Engine, EngineLoad, Request
from repro_torch.serving.paged import device as paged_dev

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(7, 10, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),
           np.arange(2, 13, dtype=np.int32),      # shared prefix (paged)
           np.arange(4, 25, dtype=np.int32)]      # multi-chunk

EQUIVALENCE = {
    "dense-async": dict(cache_kind="dense", async_mode=True),
    "dense-hybrid-sync": dict(cache_kind="dense", schedule="hybrid", prefill_chunk=4,
                              async_mode=False),
    "paged-sync": dict(cache_kind="paged", block_size=4, async_mode=False),
    "paged-async": dict(cache_kind="paged", block_size=4, async_mode=True),
    "hybrid-sync": dict(cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=4,
                        async_mode=False),
    "hybrid-async": dict(cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=4,
                         async_mode=True),
}


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
    """(JAX model, target params, draft params), the port's the same (the
    draft: the target's config with other weights, seed 1)."""
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jp, jd = jmodel.init(jax.random.key(0)), jmodel.init(jax.random.key(1))
    model = build_model(reduce_config("llama3.2-1b").with_overrides(dtype="float32"), "cpu")
    p, d = (params_from_numpy(jax.tree.map(np.asarray, x), "cpu") for x in (jp, jd))
    return (jmodel, jp, jd), (model, p, d)


def _requests(request_cls, prompts, n_new):
    return [request_cls(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]


def _run_single(model, params, prompts, n_new=5, **kw):
    eng = Engine(model, params, n_slots=4, max_seq=32, **kw)
    reqs = _requests(Request, prompts, n_new)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.out_tokens) for r in reqs]


def _disagg(cluster_cls, request_cls, model, params, prompts, n_new=5, tracer=None, **kw):
    cl = cluster_cls(model, params, 2, roles="1p+1d", tracer=tracer, n_slots=4, max_seq=32,
                     **kw)
    reqs = _requests(request_cls, prompts, n_new)
    for r in reqs:
        cl.submit(r)
    return reqs, cl.run(), cl


def same_disagg(models, prompts=PROMPTS, n_new=5, spec=False, traced=False, **kw):
    """The port's 1P+1D cluster and the JAX one on one workload: tokens,
    step stamps, ``ClusterStats``, ``RouterStats``, pool stats and (traced)
    the trace JSON equal.  Returns the port's requests, stats, cluster."""
    runs = []
    for cls, req_cls, tr, (m, p, d) in ((JCluster, JRequest, jtel, models[0]),
                                        (Cluster, Request, tel, models[1])):
        extra = dict(spec_depth=2, draft_model=m, draft_params=d) if spec else {}
        tracer = tr.Tracer(wall=False) if traced else None
        runs.append((*_disagg(cls, req_cls, m, p, prompts, n_new, tracer, **kw, **extra),
                     tracer))
    (jreqs, jstats, jcl, jtracer), (reqs, stats, cl, tracer) = runs
    for j, r in zip(jreqs, reqs):
        assert r.done and r.in_flight == 0
        assert r.out_tokens == j.out_tokens, (r.uid, r.out_tokens, j.out_tokens)
        assert (r.submit_step, r.admit_step, r.first_token_step, r.finish_step) == \
            (j.submit_step, j.admit_step, j.first_token_step, j.finish_step), r.uid
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert dataclasses.asdict(cl.router.stats) == dataclasses.asdict(jcl.router.stats)
    assert cl.placement == jcl.placement
    for e, je in zip(cl.engines, jcl.engines):
        if e.cache_kind == "paged":
            assert dataclasses.asdict(e.pool.stats) == dataclasses.asdict(je.pool.stats)
            assert e.pool.in_use == 0
    if traced:
        ours = json.dumps(tel.to_chrome_trace(tracer), sort_keys=True)
        assert ours == json.dumps(jtel.to_chrome_trace(jtracer), sort_keys=True)
        assert tel.validate_trace(json.loads(ours)) == []
    return reqs, stats, cl, tracer


# -------------------------------------------------------------- role parsing
def test_parse_roles():
    assert parse_roles(None, 3) == ["mixed"] * 3
    assert parse_roles("1p+1d", 2) == ["prefill", "decode"]
    assert parse_roles("2P+1D+1M", 4) == ["prefill", "prefill", "decode", "mixed"]
    assert parse_roles("prefill, decode", 2) == ["prefill", "decode"]
    assert parse_roles(["mixed", "mixed"], 2) == ["mixed", "mixed"]


@pytest.mark.parametrize("spec,n", [
    ("1p+1d", 3),                   # wrong length
    ("prefill,banana", 2),          # unknown role
    ("decode,decode", 2),           # nothing can admit
    ("prefill,prefill", 2),         # nowhere to migrate
    ("mixed,decode", 2),            # decode with no prefill source
])
def test_parse_roles_rejects(spec, n):
    with pytest.raises(ValueError) as ours:
        parse_roles(spec, n)
    with pytest.raises(ValueError) as theirs:
        jparse_roles(spec, n)
    assert str(ours.value) == str(theirs.value)


class _FakeEngine:
    def __init__(self, inflight=0):
        self.inflight = inflight

    def can_admit(self, req):
        return True

    def probe_prefix(self, prompt):
        return 0

    def load(self):
        return EngineLoad(free_slots=1, queued=0, inflight_tokens=self.inflight,
                          free_blocks=None)


def test_router_role_filtering():
    engines = [_FakeEngine(10), _FakeEngine(0), _FakeEngine(5)]
    r = Router(engines, "least_loaded", roles=["prefill", "decode", "mixed"])
    req = Request(uid=0, prompt=np.arange(1, 4, dtype=np.int32), max_new_tokens=2)
    # admission never ranks the decode replica; decode ranking never the
    # prefill one; both least-loaded first
    assert r.rank(req) == [2, 0]
    assert r.rank_decode() == [1, 2]
    assert r.rank_decode(exclude=1) == [2]
    assert r.rank_refold() == [2, 0]
    assert r.route(req) == 2
    with pytest.raises(ValueError):
        Router(engines, "round_robin", roles=["decode", "decode", "decode"])


def test_engine_refuses_unknown_role(models):
    model, p, _ = models[1]
    with pytest.raises(ValueError, match="unknown role 'router'"):
        Engine(model, p, n_slots=2, max_seq=32, role="router")


# ------------------------------------------------------------- equivalence
@pytest.mark.parametrize("case", EQUIVALENCE)
def test_disagg_greedy_equivalence(models, case):
    """1P+1D equals the JAX cluster, and its greedy tokens equal a single
    mixed engine's: migration moves work, never changes it."""
    kw = EQUIVALENCE[case]
    reqs, stats, _, _ = same_disagg(models, **kw)
    model, p, _ = models[1]
    assert [r.out_tokens for r in reqs] == _run_single(model, p, PROMPTS, **kw)
    assert stats.migrations > 0
    assert stats.replicas[0].routed == len(PROMPTS) and stats.replicas[1].routed == 0
    assert stats.replicas[0].engine.migrations_out == stats.migrations
    assert stats.replicas[1].engine.migrations_in == stats.migrations


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_disagg_trace_matches_reference(models, mode):
    """A traced 1P+1D run: the trace JSON (request spans, steps, the
    router row's ``route`` and ``kv_migrate`` marks) equals the JAX
    cluster's, and every request tree is well-formed."""
    _, stats, _, tracer = same_disagg(models, traced=True, cache_kind="paged", block_size=4,
                                      schedule="hybrid", prefill_chunk=4,
                                      async_mode=mode == "async")
    marks = [e for e in tracer.events if e.name == "kv_migrate"]
    assert len(marks) == stats.migrations > 0
    assert [p for t in tel.build_request_trees(tracer).values() for p in t.well_formed()] == []


def test_disagg_under_speculation_reprefills_the_draft(models):
    """An import under speculation rebuilds the draft's cache from the
    history through the draft's chunk program: tokens, migrations, draft
    steps and acceptance equal the JAX cluster's, and the plain run's
    tokens."""
    kw = dict(cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=4)
    reqs, stats, cl, _ = same_disagg(models, spec=True, **kw)
    assert stats.migrations > 0
    dst = stats.replicas[1].engine
    assert dst.migrations_in > 0 and dst.spec_steps > 0
    # the decode replica's draft chunks: its re-prefills, one per import at least
    assert dst.draft_steps - 3 * dst.spec_steps >= dst.migrations_in
    model, p, _ = models[1]
    assert [r.out_tokens for r in reqs] == _run_single(model, p, PROMPTS, **kw)


# --------------------------------------------------------- migration edges
def test_shared_prefix_export_keeps_source_intact(models):
    """Copy-on-export: exporting one of two prefix-sharing requests decrefs
    the shared blocks but leaves the other owner's blocks and hash entries
    alone; its decode continues exactly."""
    model, p, _ = models[1]
    prompt = np.arange(2, 14, dtype=np.int32)      # 12 tokens = 3 blocks
    kw = dict(cache_kind="paged", block_size=4, async_mode=False)
    solo = _run_single(model, p, [prompt], n_new=6, **kw)
    eng = Engine(model, p, n_slots=2, max_seq=32, **kw)
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=6) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()                                     # both admitted + 1 token
    shared = [b for b in eng.manager.blocks[0] if b and eng.pool.refcount(b) > 1]
    assert shared, "prefix blocks were not shared before export"
    exported = eng.export_request(1)
    assert exported is not None
    _, ticket, payload = exported
    assert ticket.n_blocks > 0 and eng.stats.migrations_out == 1
    assert payload["k"].shape[1] == ticket.n_blocks
    for b, k in zip(eng.manager.blocks[0], eng.manager.keys[0]):
        if b and k is not None:
            assert eng.pool.refcount(b) >= 1 and eng.pool.peek(k) == b
    assert int(eng.cache["lengths"][1]) == 0 and not eng.cache["block_tables"][1].any()
    eng.run()
    assert list(reqs[0].out_tokens) == solo[0]


def test_import_into_full_pool_spills_not_preempts(models):
    """An import under block pressure with a host tier spills resident
    cold-prefix blocks to make room: nobody is preempted, and both the
    resident and the migrated request finish with their solo tokens."""
    model, p, _ = models[1]
    p_res, p_mig = np.arange(3, 19, dtype=np.int32), np.arange(5, 21, dtype=np.int32)
    kw = dict(cache_kind="paged", block_size=4, async_mode=False)
    solo_res = _run_single(model, p, [p_res], n_new=6, **kw)
    solo_mig = _run_single(model, p, [p_mig], n_new=6, **kw)
    src = Engine(model, p, n_slots=1, max_seq=32, **kw)
    mig = Request(uid=1, prompt=p_mig, max_new_tokens=6)
    src.submit(mig)
    src.step()
    req, ticket, payload = src.export_request(0)
    dst = Engine(model, p, n_slots=2, max_seq=32, n_blocks=9, host_blocks=8, **kw)
    res = Request(uid=0, prompt=p_res, max_new_tokens=6)
    dst.submit(res)
    dst.step()
    assert dst.manager.import_shortfall(ticket.keys, ticket.length) > dst.pool.free_count
    assert not dst.can_import(ticket)              # conservative: no spill in the probe
    assert dst.import_request(req, ticket, payload) is not None
    assert dst.stats.preemptions == 0 and dst.pool.stats.spills > 0
    dst.run()
    assert dst.stats.preemptions == 0
    assert list(res.out_tokens) == solo_res[0] and list(mig.out_tokens) == solo_mig[0]


def _codes(a: np.ndarray) -> np.ndarray:
    """Quantized payload bytes -> signed code index (adjacent codes 1 apart)."""
    if a.dtype == np.int8:
        return a.astype(np.int64)
    b = a.view(np.uint8).astype(np.int64)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


@pytest.mark.parametrize("kv", ["bf16", "fp8", "int8"])
def test_block_copies_match_reference_bytes(kv):
    """``copy_blocks_out`` / ``copy_blocks_in`` on pools holding the same
    bytes (the reference quantizer's codes and scales): the payload and
    the pool after a scatter that skips a column are byte-equal to the
    reference's."""
    rng = np.random.default_rng(19)
    L, N, Hkv, bs, Dh = 2, 9, 2, 4, 8
    jpool, pool = {}, {}
    for key in ("k", "v"):
        x = jax.numpy.asarray(rng.standard_normal((L, N, Hkv, bs, Dh)), jax.numpy.float32)
        if kv == "bf16":
            jpool[key] = x.astype(jax.numpy.bfloat16)
        else:
            jpool[key], jpool[f"{key}_scale"] = jax.jit(jref.kv_quantize, static_argnums=1)(x, kv)
    torch_dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn, "int8": torch.int8}
    for key, a in jpool.items():
        t = torch.empty(a.shape, dtype=torch.float32 if "scale" in key else torch_dtype[kv])
        ref.byte_view(t).view(torch.uint8).view(-1).copy_(
            torch.from_numpy(np.asarray(a).view(np.uint8).reshape(-1).copy()))
        pool[key] = t
    ids, sel, dst = [6, 2, 7], [0, 2], [1, 3]
    jpayload, payload = jdev.copy_blocks_out(jpool, ids), paged_dev.copy_blocks_out(pool, ids)
    jpool = jdev.copy_blocks_in(jpool, jpayload, sel, dst)
    paged_dev.copy_blocks_in(pool, payload, sel, dst)
    for mine, theirs in ((payload, jpayload), (pool, jpool)):
        assert set(mine) == set(theirs)
        for key, t in mine.items():
            assert (ref.byte_view(t).contiguous().view(torch.uint8).numpy().tobytes()
                    == np.asarray(theirs[key]).tobytes()), key


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_quantized_migration_payload_matches_reference(models, kv):
    """A quantized pool exports its stored bytes and scale tiles.  The
    port's payload for a request equals the JAX engine's: the prompt's
    blocks byte for byte, the block its decode step appended to within one
    code and a 1e-5 relative scale (that token's K/V come from each
    framework's own f32 matmuls, as in ``tests/test_torch_tiering.py``).
    The blocks land bit-exactly on the destination (no dequantize and
    requantize) and decode there gives the solo tokens."""
    (jmodel, jp, _), (model, p, _) = models
    prompt = np.arange(2, 14, dtype=np.int32)      # 3 full blocks of 4
    kw = dict(cache_kind="paged", block_size=4, kv_dtype=kv, async_mode=False)
    exports = []
    for eng_cls, req_cls, m, params in ((JEngine, JRequest, jmodel, jp),
                                        (Engine, Request, model, p)):
        src = eng_cls(m, params, n_slots=1, max_seq=32, **kw)
        src.submit(req_cls(uid=0, prompt=prompt, max_new_tokens=6))
        src.step()
        exports.append(src.export_request(0))
    (_, jticket, jpayload), (req, ticket, payload) = exports
    assert dataclasses.asdict(ticket) == dataclasses.asdict(jticket)
    assert ticket.n_blocks == 4 and ticket.length == 13
    for name in ("k", "v", "k_scale", "v_scale"):
        theirs = np.asarray(jpayload[name])
        mine = ref.byte_view(payload[name]).numpy()
        assert mine.dtype.itemsize == theirs.dtype.itemsize and mine.shape == theirs.shape
        assert mine[:, :3].tobytes() == theirs[:, :3].tobytes(), name
        if "scale" in name:
            np.testing.assert_allclose(mine[:, 3], theirs[:, 3], rtol=1e-5, err_msg=name)
        else:
            assert np.abs(_codes(mine[:, 3]) - _codes(theirs[:, 3].view(mine.dtype))).max() <= 1
    solo = _run_single(model, p, [prompt], n_new=6, **kw)
    dst = Engine(model, p, n_slots=1, max_seq=32, **kw)
    slot = dst.import_request(req, ticket, payload)
    assert slot is not None
    ids = [b for b in dst.manager.blocks[slot] if b][:ticket.n_blocks]
    landed = paged_dev.copy_blocks_out(dst.cache, ids)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(ref.byte_view(landed[name]), ref.byte_view(payload[name])), name
    dst.run()
    assert list(req.out_tokens) == solo[0]


def test_dtype_mismatch_refuses_migration(models):
    """A ticket of another ``kv_dtype`` is refused by ``can_import`` and
    ``import_request``: migration copies storage, never requantizes."""
    model, p, _ = models[1]
    src = Engine(model, p, n_slots=1, max_seq=32, cache_kind="paged", block_size=4,
                 kv_dtype="fp8", async_mode=False)
    src.submit(Request(uid=0, prompt=PROMPTS[0], max_new_tokens=4))
    src.step()
    ticket = src.preview_export(0)
    assert ticket is not None and ticket.kv_dtype == "fp8"
    dst = Engine(model, p, n_slots=1, max_seq=32, cache_kind="paged", block_size=4,
                 kv_dtype="bf16", async_mode=False)
    assert not dst.can_import(ticket)
    req, ticket, payload = src.export_request(0)
    assert dst.import_request(req, ticket, payload) is None
    assert dst.slots == [None] and dst.pool.in_use == 0
    with pytest.raises(ValueError, match="pool stores"):
        paged_dev.copy_blocks_in(dst.cache, payload, [0], [1])


def test_refold_move_reproduces_decode(models):
    """A preempted request stranded at a busy replica's queue front
    refolds on the least-loaded replica and continues its greedy decode
    exactly."""
    model, p, _ = models[1]
    kw = dict(cache_kind="paged", block_size=4, async_mode=False)
    prompt = np.arange(2, 14, dtype=np.int32)
    solo = _run_single(model, p, [prompt], n_new=6, **kw)
    cl = Cluster(model, p, 2, n_slots=1, max_seq=32, **kw)
    blocker = Request(uid=0, prompt=PROMPTS[4], max_new_tokens=8)
    cl.submit(blocker)
    cl.step()                                      # occupies r0's only slot
    assert cl.engines[0].slots[0] is blocker
    refold = Request(uid=1, prompt=prompt, max_new_tokens=6)
    refold.out_tokens.append(solo[0][0])
    refold.first_token_step = 1
    cl.engines[0].sched.push_front(refold)
    assert not cl.engines[0].can_admit_next()
    assert cl._rebalance_refolds() == 1
    assert cl.refold_moves == 1 and cl.placement[1] == 1
    assert cl.engines[1].sched.peek() is refold
    cl.run()
    assert list(refold.out_tokens) == solo[0]
    assert list(blocker.out_tokens) == _run_single(model, p, [PROMPTS[4]], n_new=8, **kw)[0]


# ------------------------------------------------------------- serve CLI
def _pick(lines, prefix):
    return [line for line in lines if line.startswith(prefix)]


@pytest.mark.parametrize("cluster", [["--route", "prefix_affinity"], ["--role-map", "1p+1d"]],
                         ids=["prefix-affinity", "1p+1d"])
def test_serve_cli_cluster_prints_reference_lines(capsys, monkeypatch, cluster):
    """``--replicas 2`` with prefix affinity or a 1P+1D role map, paged and
    hybrid: the ``cluster:``, ``requests=``, ``disagg:``, ``latency:`` and
    ``pool[r{i}]:`` lines equal the reference CLI's (bf16, as the CLIs run;
    ``--workload-seed 1``)."""
    flags = ["--reduced", "--requests", "6", "--slots", "2", "--max-new", "5",
             "--max-seq", "32", "--workload-seed", "1", "--replicas", "2", "--cache", "paged",
             "--schedule", "hybrid", "--block-size", "4", "--prefill-chunk", "8", *cluster]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    for prefix in ("cluster:", "requests=", "disagg:", "latency:", "pool"):
        assert _pick(mine, prefix) == _pick(theirs, prefix), prefix
    assert _pick(mine, "cluster:") and len(_pick(mine, "pool[r")) == 2
    if "--role-map" in cluster:
        assert _pick(mine, "disagg: migrations=")
