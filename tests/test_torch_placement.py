"""Placement for serving, in one process: the port's rules, spec
resolver, balancer and cache stand-ins against ``repro.core.placement``,
``repro.models.common``, ``repro.core.balance`` and
``repro.launch.specs``; the decode kernel's lse plain version by windows;
a placed model on a mesh of one rank; the refusals.  The multi-rank
worlds are in ``test_torch_placement_world.py`` (8 ranks, the sharded
model) and ``test_torch_placement_engine.py`` (2 ranks, the engine).
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core import balance as jbalance
from repro.core import placement as jplacement
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import common as jcm
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import balance, placement
from repro_torch.core.placement import Env
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve, specs
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request

MESHES = {"one": {}, "4x2": {"data": 4, "model": 2}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the serve CLI's line for llama3.2-1b on one rank (chip_smoke.py holds
# the card's run to it)
LLAMA_BALANCER = ("balancer: policy=batch sub_batches=1 bottleneck=attention "
                  "(t_att=167.81ms t_lin=3.66ms)")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _same_specs(mine, theirs):
    a, b = dict(_flat(mine)), dict(_flat(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(a[k]) == tuple(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", all_arch_ids())
def test_rules_specs_and_plan_match_reference(arch, mesh):
    """For every arch id and mesh: the policies' rules, the cache specs
    they resolve, every weight's spec (with the row-parallel fallback),
    and the balancer's plan equal the reference's."""
    axes = MESHES[mesh]
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    dims = (B, S, max(cfg.n_kv_heads, 1), cfg.resolved_head_dim())
    assert placement.POLICIES == jplacement.POLICIES
    assert placement.activation_rules() == jplacement.activation_rules()
    assert placement.param_rules(fsdp=True) == jplacement.param_rules(fsdp=True)
    for policy in placement.POLICIES:
        rules = placement.kv_rules(policy)
        assert rules == jplacement.kv_rules(policy)
        for logical in (placement.KV_CACHE_AXES, placement.PAGED_KV_CACHE_AXES):
            assert tuple(cm.resolve_spec(logical, rules, axes, dims)) == \
                tuple(jcm.resolve_spec(logical, rules, axes, dims))
        env = Env(axes=axes, kv_policy=policy)
        jmodel = jbuild_model(jcfg, jplacement.Env(axes=axes, kv_policy=policy))
        model = dataclasses.replace(build_model(cfg, "meta"), env=env)
        _same_specs(model.cache_specs(B, S), jmodel.cache_specs(B, S))
        if policy == "batch":
            _same_specs(model.param_specs(), jmodel.param_specs())
    p, jp = balance.plan(cfg, shape, axes), jbalance.plan(jcfg, JSHAPES["decode_32k"], axes)
    assert p.__dict__ == jp.__dict__


def test_balancer_line_and_env_match_reference(capsys, monkeypatch):
    """The serve CLI prints the reference's ``balancer:`` line first and
    builds the reference's Env (no axes on one rank); the full
    llama3.2-1b line is pinned (chip_smoke.py checks the card's run)."""
    flags = ["--reduced", "--requests", "2", "--slots", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert mine[0].startswith("balancer:") and mine[0] == theirs[0]
    args = serve.build_parser().parse_args(["--device", "cpu"])
    mesh, env, line = serve.place(args, get_config("llama3.2-1b"))
    assert line == LLAMA_BALANCER
    assert lmesh.mesh_axes(mesh) == {"data": 1, "model": 1} and env == Env(kv_policy="batch")


def test_stand_ins_match_reference():
    """``decode_inputs`` / ``prefill_inputs`` shapes and dtypes equal the
    reference's ``eval_shape`` stand-ins; ``cache_shardings`` its specs."""
    for arch in ("llama3.2-1b", "deepseek-v3-671b", "internvl2-76b", "seamless-m4t-medium"):
        cfg, jcfg = reduce_config(arch), jreduce_config(arch)
        shape = ShapeConfig("cell", 64, 4, "decode")
        env = Env(axes={"data": 2, "model": 2}, kv_policy="sequence")
        jenv = jplacement.Env(axes={"data": 2, "model": 2}, kv_policy="sequence")
        model = dataclasses.replace(build_model(cfg, "meta"), env=env)
        jmodel = jbuild_model(jcfg, jenv)
        cache, toks = specs.decode_inputs(model, shape)
        jcache, jtoks = jspecs.decode_inputs(jmodel, shape)
        assert tuple(toks.shape) == jtoks.shape and toks.device.type == "meta"
        for k in jcache:
            assert tuple(cache[k].shape) == jcache[k].shape, (arch, k)
            assert str(cache[k].dtype).split(".")[-1] == str(jcache[k].dtype), (arch, k)
        ptoks, _, emb = specs.prefill_inputs(model, shape)
        jptoks, _, jemb = jspecs.prefill_inputs(jmodel, shape)
        assert tuple(ptoks.shape) == jptoks.shape
        assert (emb is None) == (jemb is None)
        _same_specs(specs.cache_shardings(model, cache), jmodel.cache_specs(4, 64))


def test_one_process_mesh_initialises_nothing():
    mesh = lmesh.make_host_mesh()
    assert lmesh.mesh_axes(mesh) == {"data": 1, "model": 1}
    assert not torch.distributed.is_initialized()
    assert mesh.group(("data", "model")) is None and mesh.index(("data",)) == 0
    meshes = lmesh.replica_meshes(2)      # a world of one cannot be split: shared
    assert len(meshes) == 2 and meshes[0] is meshes[1]
    assert lmesh.backend_for(torch.device("cpu")) == "gloo"


def _windows(S: int, n: int):
    return [(i * S // n, (i + 1) * S // n) for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_decode_lse_plain_version_by_windows(n):
    """The decode kernel's lse plain version over each window of a cache
    split by positions equals ``ref.attention_lse`` there; the windows
    merged by ``ref.lse_merge`` equal the whole cache's attention, empty
    windows and empty rows included (0, never NaN)."""
    g = torch.Generator().manual_seed(n)
    B, S, Hkv, G, D = 4, 32, 2, 4, 16
    q = torch.randn(B, Hkv * G, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    lengths = torch.tensor([S, 3, 0, S // 2 + 1])
    whole = ref.naive_decode_attention(q, k, v, lengths)
    parts = []
    for s0, s1 in _windows(S, n):
        win = (lengths - s0).clamp(0, s1 - s0)
        o, lse = ops.decode_attention(q, k[:, s0:s1], v[:, s0:s1], win, return_lse=True)
        assert lse.shape == (B, Hkv, G) and lse.dtype == torch.float32
        for b in range(B):
            if win[b] == 0:
                assert (lse[b] <= -1e30).all() and (o[b] == 0).all()
                continue
            want = ref.attention_lse(q[b:b + 1, None], k[b:b + 1, s0:s0 + int(win[b])],
                                     causal=False)
            torch.testing.assert_close(lse[b].reshape(-1), want.reshape(-1), rtol=0, atol=1e-5)
        parts.append((o, lse))
    merged = ref.lse_merge(parts)
    torch.testing.assert_close(merged[lengths > 0], whole[lengths > 0], rtol=0, atol=1e-5)
    assert (merged[lengths == 0] == 0).all() and not merged.isnan().any()


def test_model_level_windows_share_the_maximum():
    """The CPU route of the sequence policies: windows that share their
    maximum give the one-device plain attention's output (p rounded to
    the cache's bf16 the same way), merged by lse."""
    g = torch.Generator().manual_seed(5)
    B, S, Hkv, G, D = 3, 16, 2, 2, 16
    q = torch.randn(B, Hkv * G, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=g).bfloat16()
    lengths = torch.tensor([16, 5, 9])
    whole = attn.decode_attention(q, k, v, lengths)
    wins = _windows(S, 4)
    m = torch.stack([attn.decode_scores(q, k[:, a:b], (lengths - a).clamp(0, b - a))
                     .amax(-1, keepdim=True) for a, b in wins]).amax(0)
    parts = [attn.decode_attention(q, k[:, a:b], v[:, a:b], (lengths - a).clamp(0, b - a),
                                   m=m, return_lse=True) for a, b in wins]
    torch.testing.assert_close(ref.lse_merge(parts), whole, rtol=0, atol=1e-6)


def _one_rank(policy="batch"):
    cfg = reduce_config("llama3.2-1b").with_overrides(dtype="float32")
    mesh = lmesh.DeviceMesh({"data": 1, "model": 1})
    return build_model(cfg, "cpu", Env(axes={"data": 1, "model": 1}, kv_policy=policy), mesh)


@pytest.mark.parametrize("policy", placement.POLICIES)
def test_placed_model_on_one_rank_equals_the_model(policy):
    """A mesh of one rank runs the placed path with no collective: the
    same logits and tokens as the model on one device."""
    model = _one_rank(policy)
    plain = build_model(model.cfg, "cpu")
    params = plain.init(0)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(model.init(0)), _flat(params)))
    toks = torch.randint(0, model.cfg.vocab, (2, 7), generator=torch.Generator().manual_seed(1))
    out = []
    for m in (model, plain):
        cache = m.init_cache(2, 16)
        lp, _ = m.prefill(params, toks, cache)
        ld, _ = m.decode_step(params, cache, lp.argmax(-1).to(torch.int32))
        out.append((lp, ld, cache["k"].clone()))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_placed_engine_refusals():
    """What a placed engine does not serve is refused with a clear error
    naming it: CUDA graphs; and a family other than the dense one is
    refused when the model is built.  A replica of a cluster and a
    disaggregated role are served since per-replica meshes (the serve
    CLI's clustered runs on a placed model finish every request;
    ``test_torch_cluster_world.py`` holds them to the reference), as are
    the host tier, speculation, sub-batches and the int8 cache
    (``test_torch_placement_tiered.py``, ``test_torch_placement_spec.py``),
    the paged pool and the hybrid schedule
    (``test_torch_placement_paged.py``)."""
    model = _one_rank()
    params = model.init(0)
    with pytest.raises(ValueError, match="eagerly"):
        Engine(model, params, n_slots=2, max_seq=16, graphs=True)
    for kw in ({}, dict(cache_kind="paged", block_size=4, schedule="hybrid", prefill_chunk=4),
               dict(cache_kind="paged", block_size=4, host_blocks=4, kv_dtype="fp8"),
               dict(sub_batches=2),
               dict(spec_depth=1, draft_model=model, draft_params=params, prefill_chunk=8),
               dict(replica=1), dict(role="prefill"), dict(cache_kind="paged", replica=1)):
        eng = Engine(model, params, n_slots=2, max_seq=16, **kw)
        reqs = [Request(uid=i, prompt=np.arange(1, 4 + i, dtype=np.int32), max_new_tokens=3)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        assert eng.run().generated == 9 and not eng.graphs
    for flags in (["--replicas", "2"], ["--replicas", "2", "--cache", "paged", "--host-blocks", "4"],
                  ["--replicas", "2", "--role-map", "1p+1d"]):
        args = serve.build_parser().parse_args(
            ["--reduced", "--device", "cpu", "--requests", "2", *flags])
        res = serve.serve(args, model, params, draft=(model, params))
        assert all(r.done for r in res.driver.submitted)
        assert all(e.model is model and e.member for e in res.cluster.engines)
    for arch in ("rwkv6-7b", "moonshot-v1-16b-a3b"):
        with pytest.raises(NotImplementedError, match="placement serves the dense family only"):
            build_model(reduce_config(arch), "cpu", Env(axes={"data": 1, "model": 1}),
                        lmesh.DeviceMesh({"data": 1, "model": 1}))
    quant = build_model(reduce_config("llama3.2-1b").with_overrides(kv_quant=True), "cpu",
                        Env(axes={"data": 1, "model": 1}), lmesh.DeviceMesh({"data": 1,
                                                                             "model": 1}))
    assert quant.placement is not None and quant.verify_step is not None


@pytest.mark.parametrize("field", sorted([*placement.NOT_PLACED_YET, "sub_batches"]))
def test_env_refuses_the_fields_not_placed_yet(field):
    """``Env`` carries the reference's fields at the reference's defaults;
    one the port does not run yet, set off its default, raises, naming the
    part of the ROADMAP it waits for.  ``sub_batches`` is placed now (the
    engine runs its sub-batches on a mesh): ``Env`` takes it."""
    default, why = placement.NOT_PLACED_YET.get(field, (1, None))
    assert getattr(jplacement.Env(), field) == getattr(Env(), field) == default
    off = {field: 2 if isinstance(default, int) and not isinstance(default, bool)
           else not default}
    if why is None:
        assert Env(**off).sub_batches == 2
        return
    with pytest.raises(NotImplementedError, match=f"{field} waits for item 9"):
        Env(**off)
