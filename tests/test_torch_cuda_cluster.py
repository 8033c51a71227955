"""The cluster tier and sub-batch pipelining on the card: KV block
migration is bit exact (the blocks an export gathers equal, with
``torch.equal`` on their bytes, the blocks the import lands, for a bf16
pool and an fp8 pool with its scale pools), a float32 1P+1D cluster on the
card gives the CPU cluster's tokens and clocks, and a ``sub_batches=2``
engine under CUDA graphs gives its eager run's tokens and those of a plain
engine whose batch is one sub-batch, with the dense decode kernel launched
once per sub-batch and layer.  Every test here is
marked ``cuda`` and skips (inside its fixture) where no GPU is visible.
This file imports torch and the port only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_cluster.py

Tolerances: none; every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build_model
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged import device as paged_dev

pytestmark = pytest.mark.cuda

PROMPTS = [np.random.default_rng(s).integers(1, 400, n).astype(np.int32)
           for s, n in enumerate((5, 3, 11, 11, 21, 4, 9, 6))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels and CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    m = build_model(reduce_config("llama3.2-1b"), cuda)
    return m, m.init(3)


def _serve(server, prompts, n_new=6):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        server.submit(r)
    stats = server.run()
    torch.cuda.synchronize()
    return [r.out_tokens for r in reqs], stats


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_migration_is_bit_exact_on_the_card(model, kv):
    """Export a decoding request from one engine and import it into
    another: the imported blocks (and scale tiles) equal the exported
    payload byte for byte, the payload equals the source's blocks as they
    were, and decode continues with the solo run's tokens."""
    m, params = model
    prompt = PROMPTS[4]
    kw = dict(n_slots=2, max_seq=64, cache_kind="paged", block_size=4, kv_dtype=kv)
    solo, _ = _serve(Engine(m, params, **kw), [prompt])
    src = Engine(m, params, **kw)
    req = Request(uid=0, prompt=prompt, max_new_tokens=6)
    src.submit(req)
    src.step()
    src.step()
    ids = list(src.manager.blocks[0])
    keys = ("k", "v", "k_scale", "v_scale") if kv == "fp8" else ("k", "v")
    before = {k: ref.byte_view(src.cache[k][:, ids]).clone() for k in keys}
    req, ticket, payload = src.export_request(0)
    assert set(payload) == set(keys)
    for key, t in payload.items():
        assert t.is_cuda and torch.equal(ref.byte_view(t), before[key]), key
    dst = Engine(m, params, **kw)
    slot = dst.import_request(req, ticket, payload)
    landed = paged_dev.copy_blocks_out(dst.cache, dst.manager.blocks[slot][:ticket.n_blocks])
    for key, t in payload.items():
        assert torch.equal(ref.byte_view(landed[key]), ref.byte_view(t)), key
    dst.run()
    torch.cuda.synchronize()
    assert req.out_tokens == solo[0]


def test_float32_disagg_cluster_matches_the_cpu(cuda):
    """Reduced llama3.2-1b in float32, the same weights on the card and on
    the CPU: a 1P+1D paged hybrid cluster under CUDA graphs gives the CPU
    cluster's tokens, migrations, rounds and engine clocks."""
    cfg = reduce_config("llama3.2-1b").with_overrides(dtype="float32")
    gpu, cpu = build_model(cfg, cuda), build_model(cfg, "cpu")
    p_gpu = gpu.init(3)
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
             for k, v in p_gpu.items()}
    kw = dict(roles="1p+1d", n_slots=3, max_seq=64, cache_kind="paged", block_size=4,
              schedule="hybrid", prefill_chunk=8)
    runs = [_serve(Cluster(m, p, 2, **kw), PROMPTS) for m, p in ((gpu, p_gpu), (cpu, p_cpu))]
    (toks, st), (ctoks, cst) = runs
    assert st.migrations > 0
    assert toks == ctoks
    assert dataclasses.asdict(st) == dataclasses.asdict(cst)


def test_sub_batches_under_graphs_match_eager(model):
    """``sub_batches=2``, sync and async: the captured decode program (two
    stream branches in one graph) gives the eager run's tokens and clock,
    and the dense decode kernel runs once per sub-batch and layer."""
    m, params = model
    for async_mode in (True, False):
        runs = []
        for graphs in (True, False):
            eng = Engine(m, params, n_slots=4, max_seq=64, sub_batches=2, graphs=graphs,
                         async_mode=async_mode)
            ops.reset_launch_counts()
            toks, st = _serve(eng, PROMPTS)
            runs.append((toks, st, ops.variant_counts()["decode_attention"], eng))
        (toks, st, launches, eng), (etoks, est, elaunches, _) = runs
        # a plain engine whose decode batch is one sub-batch's 2 rows: its
        # GEMMs have a sub-batch's shapes, so its tokens are exactly these
        narrow, _ = _serve(Engine(m, params, n_slots=2, max_seq=64, async_mode=async_mode),
                           PROMPTS)
        assert toks == etoks == narrow and st == est
        assert launches == elaunches == {"unscaled": 2 * st.decode_steps * m.cfg.n_layers}
        decode = eng.programs["decode"]
        assert decode.graph is not None and decode.replays == st.decode_steps - 1
