"""Speculative decoding, sub-batch pipelining and the int8 dense cache on
a mesh.

A 2-rank world (gloo) on data 2 and on model 2 against the JAX engine in
float32 with its weights carried across: speculative decoding at depth
2 on the dense cache and on the paged pool with the hybrid schedule (the
draft the target's config on other weights, placed on the same mesh as
the reference builds it: its proposals mostly miss, so the rejection
path runs), ``sub_batches=2`` on the dense cache (each sub-batch takes
an equal part of every lane's rows), and the ``kv_quant`` dense cache
(int8 K/V with bf16 scales, each rank writing and dequantizing its
shard), sync and async: tokens, step stamps, ``EngineStats`` and
``PoolStats`` equal on every rank; a frontend's embeds prefilled on a
mesh.  The serve CLI under ``--spec-depth 2`` and ``--sub-batches 2``:
rank 0 prints the reference CLI's lines, rank 1 the same ``spec:`` line.
Then, in one process, a placed cache's sub-batch views against the
reference's functional split and merge.

The reference's paged async engine runs with its ``sync_slot`` race
removed (``test_torch_placement_tiered.copied_rows``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_placement_tiered import (MODES, assert_cli, assert_engine, copied_rows,
                                         jax_cli, jax_engine)
from torch_placement_worker import flat, run_world

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core import pipeline as jpipeline
from repro.core.placement import Env as JEnv
from repro.models.registry import build_model as jbuild_model
from repro_torch.core import pipeline
from repro_torch.core.offload import ShardedCache

SLOTS, MAX_SEQ, MAX_NEW = 4, 40, 8
PROMPTS = [list(range(1, 6)), list(range(7, 10)), list(range(2, 13)), list(range(4, 25)),
           list(range(30, 36))]
SPEC = dict(spec_depth=2, draft=True)
PAGED = dict(cache_kind="paged", block_size=8, n_blocks=22, schedule="hybrid",
             prefill_chunk=8)
BOTH = {1: ["batch"], 2: ["sequence", "head"]}
# name -> (Engine keywords, {model axis size: policies}, the JAX model's config overrides)
CASES = {
    "spec": (SPEC, BOTH, {}),
    "spec-paged-hybrid": (dict(SPEC, **PAGED), BOTH, {}),
    "sub-batches": (dict(sub_batches=2), {1: ["batch", "sequence"], 2: ["sequence", "head"]},
                    {}),
    "kv-quant": (dict(kv_quant=True), {1: ["batch", "sequence"], 2: ["sequence", "head"]},
                 {"kv_quant": True}),
}
CLI = ["--requests", "5", "--slots", "4", "--max-new", "6", "--max-seq", "32",
       "--workload-seed", "1"]
CLI_FLAGS = {"spec": CLI + ["--spec-depth", "2"],
             "spec-paged": CLI + ["--spec-depth", "2", "--cache", "paged", "--block-size", "4",
                                  "--blocks", "34", "--schedule", "hybrid",
                                  "--prefill-chunk", "8"],
             "sub-batches": CLI + ["--sub-batches", "2"]}


# a frontend's embeds prefilled on a mesh: (model axis size, policy)
EMBEDS = [(1, "batch"), (2, "sequence"), (2, "head")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spec2")
    cfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    models = {}
    params = jbuild_model(cfg, JEnv()).init(jax.random.key(0))
    # embeds (B 4, F 3) then 5 tokens, one decode step: the reference's logits
    rng = np.random.default_rng(5)
    emb = {"embeds": rng.standard_normal((4, 3, cfg.d_model)).astype(np.float32) * 0.02,
           "tokens": rng.integers(0, cfg.vocab, (4, 5)).astype(np.int32),
           "feed": rng.integers(0, cfg.vocab, 4).astype(np.int32)}
    np.savez(tmp / "embeds.npz", **emb)
    jm = jbuild_model(cfg, JEnv())
    jcache = jm.init_cache(4, MAX_SEQ)
    jpre, jcache = jm.prefill(params, jnp.asarray(emb["tokens"]), jcache,
                              embeds=jnp.asarray(emb["embeds"]))
    jdec, _ = jm.decode_step(params, jcache, jnp.asarray(emb["feed"]))
    embeds_want = (np.asarray(jpre, np.float32), np.asarray(jdec, np.float32))
    draft = jbuild_model(cfg, JEnv()).init(jax.random.key(1))
    for name, tree in (("float32", params), ("draft", draft)):
        np.savez(tmp / f"params_{name}.npz",
                 **{k: np.asarray(v, np.float32) for k, v in flat(tree)})
    want = {}
    with copied_rows():
        for name, (kw, _, overrides) in CASES.items():
            key = tuple(sorted(overrides.items()))
            m = models.setdefault(key, jbuild_model(cfg.with_overrides(**overrides), JEnv()))
            kw = {k: v for k, v in kw.items() if k not in ("draft", "kv_quant")}
            if "spec_depth" in kw:
                kw.update(draft_model=m, draft_params=draft)
            for mode in MODES:
                want[(name, mode)] = jax_engine(m, params, kw, mode, PROMPTS, n_slots=SLOTS,
                                                max_seq=MAX_SEQ, max_new=MAX_NEW)
        cli = {name: jax_cli(flags) for name, flags in CLI_FLAGS.items()}
    cases = [[f"{name}-{mp}", mp, policies, kw] for name, (kw, by_mp, _) in CASES.items()
             for mp, policies in by_mp.items()]
    outs = run_world(2, dict(kind="paged_engine", cases=cases, vocab=cfg.vocab, slots=SLOTS,
                             max_seq=MAX_SEQ, max_new=MAX_NEW, prompts=PROMPTS,
                             cli=list(CLI_FLAGS.values()), embeds=EMBEDS), tmp)
    return want, cli, outs, embeds_want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [(name, mp, policy) for name, (_, by_mp, _) in CASES.items()
                                  for mp, pols in by_mp.items() for policy in pols],
                         ids=lambda c: f"{c[0]}-{'data2' if c[1] == 1 else 'model2'}-{c[2]}")
def test_placed_engine_matches_reference(world, case, mode):
    want, _, outs, _ = world
    name, mp, policy = case
    assert_engine(outs, f"{name}-{mp}/{policy}/{mode}", want[(name, mode)])
    _, stats, _ = want[(name, mode)]
    if name.startswith("spec"):
        assert stats["spec_steps"] > 0 and stats["drafted_tokens"] > stats["accepted_tokens"]


@pytest.mark.parametrize("name", CLI_FLAGS)
def test_placed_serve_cli_prints_reference_lines(world, name):
    """``--spec-depth 2`` (dense and paged hybrid) and ``--sub-batches 2``
    under a 2-rank world (data 2, the batch policy; the draft placed on
    the same mesh): rank 0's ``requests=``, ``latency:`` (and ``spec:``,
    ``pool:``) lines are the reference CLI's; rank 1 prints its ``spec:``
    and ``pool:`` lines, the same."""
    _, cli, outs, _ = world
    theirs = cli[name]
    prefixes = ("requests=", "latency:") + (("spec:",) if "spec" in name else ()) + (
        ("pool:",) if "paged" in name else ())
    assert_cli(outs, theirs, list(CLI_FLAGS).index(name), prefixes, ("pool:", "spec:"))


@pytest.mark.parametrize("case", EMBEDS,
                         ids=lambda c: f"{'data2' if c[0] == 1 else 'model2'}-{c[1]}")
def test_placed_prefill_with_embeds_matches_reference(world, case):
    """A frontend's embeds prepended on a mesh take cache positions as on
    one device: the prefill's and the next decode step's logits on every
    rank within 1e-4 of the reference's (float32)."""
    *_, outs, (pre, dec) = world
    mp, policy = case
    for o in outs:
        for name, want in (("prefill", pre), ("decode", dec)):
            got = o[f"embeds/{mp}/{policy}/{name}"]
            np.testing.assert_array_equal(got, outs[0][f"embeds/{mp}/{policy}/{name}"])
            assert float(np.abs(got - want).max()) < 1e-4, name


def _placed_cache(batch, lanes, lane):
    """A placed dense cache of ``batch`` rows over ``lanes`` lanes, this
    rank's ``lane``: leaves of recognisable values (row index)."""
    b = batch // lanes
    rows = torch.arange(lane * b, (lane + 1) * b, dtype=torch.float32)
    k = rows.view(1, b, 1, 1, 1).expand(2, b, 4, 1, 2).clone()
    return ShardedCache({"k": k, "v": -k, "lengths": rows.int()}, batch=batch, max_seq=4,
                        n_kv=1, rows=(lane * b, (lane + 1) * b), seq=(0, 4), heads=(0, 1),
                        row_axes=("data",) if lanes > 1 else ())


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_sub_batch_views_of_a_placed_cache(lanes):
    """Each sub-batch of a placed cache takes the ``i``-th part of every
    lane's rows: on one lane the reference's split (ranges of global rows,
    ``repro.core.pipeline.split_cache``); on 2 and 4 lanes the views hold
    exactly the rows ``sub_rows`` names, cut as a cache of the sub-batch's
    size would be; a write into a view lands in the cache, and the merge
    gives the cache back."""
    B, n_sub = 8, 2
    for lane in range(lanes):
        cache = _placed_cache(B, lanes, lane)
        subs = pipeline.split_cache(cache, n_sub, pipeline.default_batch_axes(cache))
        for i, sub in enumerate(subs):
            rows = cache.sub_rows(n_sub, i)
            held = rows[sub.rows[0]:sub.rows[1]]
            assert sub.batch == B // n_sub and len(rows) == B // n_sub
            assert sub.rows == (lane * B // lanes // n_sub, (lane + 1) * B // lanes // n_sub)
            assert sub["lengths"].tolist() == held and sub["k"][0, :, 0, 0, 0].tolist() == held
        if lanes == 1:
            theirs = jpipeline.split_cache({k: np.asarray(v) for k, v in cache.items()}, n_sub,
                                           jpipeline.default_batch_axes(cache))
            for mine, ref in zip(subs, theirs):
                for k in mine:
                    np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(ref[k]))
        merged = pipeline.merge_cache(subs, pipeline.default_batch_axes(cache))
        assert merged.rows == cache.rows and merged.batch == B
        for k in cache:
            assert torch.equal(merged[k], cache[k])
        subs[-1]["lengths"].add_(100)
        assert cache["lengths"].tolist()[-1] >= 100
