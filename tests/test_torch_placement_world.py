"""The placed dense model on an 8-rank CPU world (gloo, mesh data 4 x
model 2) against the JAX model on one device, on the same weights:
``tests/test_sharded.py``'s reduced llama (2 layers, d_model 64, 4/2 heads
of 16, d_ff 128, vocab 256), B 4, a prompt of 8, a cache of 16; prefill,
then one teacher-forced decode step, under each KV policy.  The logits
of every rank are the whole batch's and are the same on every rank;
they are within 5e-2 of the reference in bf16 (``test_sharded.py``'s
bound for GSPMD's own sharded run) and 1e-4 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_placement_worker import flat, run_world

from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import POLICIES, Env
from repro.models.registry import build_model as jbuild_model

B, SQ, S, VOCAB = 4, 8, 16, 256
TOL = {"bfloat16": 5e-2, "float32": 1e-4}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world8")
    toks = np.random.default_rng(1).integers(0, VOCAB, (B, SQ))
    want = {}
    feed = None
    for dtype in TOL:
        cfg = jreduce_config("llama3.2-1b").with_overrides(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=VOCAB,
            head_dim=16, dtype=dtype)
        m = jbuild_model(cfg, Env())
        params = m.init(jax.random.key(0))
        np.savez(tmp / f"params_{dtype}.npz",
                 **{k: np.asarray(v, np.float32) for k, v in flat(params)})
        log, cache = jax.jit(m.prefill)(params, jnp.asarray(toks), m.init_cache(B, S))
        if feed is None:                     # one feed for both dtypes
            feed = np.asarray(jnp.argmax(log, -1), np.int32)
        logd, _ = jax.jit(m.decode_step)(params, cache, jnp.asarray(feed))
        want[dtype] = (np.asarray(log, np.float32), np.asarray(logd, np.float32))
    outs = run_world(8, dict(kind="model", model_parallel=2, vocab=VOCAB, dtypes=list(TOL),
                             policies=list(POLICIES), tokens=toks.tolist(),
                             feed=feed.tolist(), max_seq=S), tmp)
    return want, outs


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", list(TOL))
def test_sharded_prefill_and_decode_match_reference(world, dtype, policy):
    want, outs = world
    for i, step in enumerate(("prefill", "decode")):
        got = outs[0][f"{dtype}/{policy}/{step}"]
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"{dtype}/{policy}/{step}"], got)
        err = float(np.abs(got - want[dtype][i]).max())
        assert err < TOL[dtype], (step, err)


def test_each_rank_holds_its_shard_of_the_cache(world):
    """The caches are allocated at the shard's shape: K and V of 2 layers
    x B 4 x S 16 x 2 heads x 16 in bf16 (16384 bytes whole) and 4 lengths,
    over 8 ranks as each policy splits them (batch: rows over data, heads
    over model; head: heads over model; sequence: positions over all 8;
    batch_seq: rows over data, positions over model; none: rows over
    data, replicated over model)."""
    _, outs = world
    kv = 2 * 2 * B * S * 2 * 16 * 2
    want = {"batch": kv // 8 + 4, "head": kv // 2 + 16, "sequence": kv // 8 + 16,
            "batch_seq": kv // 8 + 4, "none": kv // 4 + 4}
    for policy, n in want.items():
        assert [int(o[f"bfloat16/{policy}/kv_bytes"]) for o in outs] == [n] * 8, policy
