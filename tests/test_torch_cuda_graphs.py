"""The engine's per-kind CUDA graphs on the card: every dispatch kind
captured and replayed against the same engine run eagerly, the prefill
kernel at a device ``q_offset``, fresh random draws on every replay, and
a capture that fails.  Every test here is marked ``cuda`` and skips
(inside its fixture) where no GPU is visible.  This file imports torch
and the port only, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py

Tolerances: graphs against eager bit for bit (the same kernels on the
same inputs); sampled tokens by a chi-square bound stated at the test.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduce_config
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.programs import Program
from repro_torch.serving.sampler import SamplerConfig, sample_on_device

pytestmark = pytest.mark.cuda

# a multi-chunk head (solo), then short prompts: boundary packing with
# decodes in flight (fused, fused2, solo2)
WORKLOADS = [[np.random.default_rng(s).integers(1, 400, n).astype(np.int32) for n in lens]
             for s, lens in ((0, (5, 3, 11, 4, 6, 2, 9, 3)), (1, (11, 5, 3, 4, 6, 2, 9, 3)))]
COMBOS = {
    "dense/decode-only": {},
    "dense/hybrid": dict(schedule="hybrid", prefill_chunk=8),
    "paged/decode-only": dict(cache_kind="paged", block_size=8),
    "paged/hybrid": dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8),
    "paged-fp8-host/hybrid": dict(cache_kind="paged", block_size=4, n_blocks=13, kv_dtype="fp8",
                                  host_blocks=8, schedule="hybrid", prefill_chunk=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    m = build_model(reduce_config("llama3.2-1b"), cuda)
    return m, m.init(3)


def _serve(m, params, prompts, graphs, **kw):
    eng = Engine(m, params, n_slots=3, max_seq=32, graphs=graphs, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return [r.out_tokens for r in reqs], eng


def _state(eng) -> dict[str, torch.Tensor]:
    caches = {"cache": eng.cache, "staging": getattr(eng, "staging", {}),
              "d_cache": getattr(eng, "d_cache", {})}
    return {f"{c}.{k}": v.clone() for c, leaves in caches.items() for k, v in leaves.items()}


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("combo", [*COMBOS, "dense/hybrid/spec", "paged/hybrid/spec",
                                   "dense/decode-only/spec"])
def test_every_kind_replayed_equals_eager(model, combo, mode):
    """The same workloads through graphs and eagerly (reduced bf16
    model): tokens, every cache leaf (the staging and the draft's too)
    and launch counts equal bit for bit, and every kind that ran more
    than once was replayed."""
    m, params = model
    kw = dict(COMBOS[combo.removesuffix("/spec")], async_mode=mode == "async")
    if combo.endswith("/spec"):
        kw.update(spec_depth=2, draft_model=m, draft_params=m.init(5))
    for prompts in WORKLOADS:
        runs = []
        for graphs in (True, False):
            ops.reset_launch_counts()
            toks, eng = _serve(m, params, prompts, graphs, **kw)
            runs.append((toks, _state(eng), ops.shape_counts(), eng))
        (tg, sg, cg, eg), (te, se, ce, _) = runs
        assert tg == te
        assert sg.keys() == se.keys()
        for k in sg:
            assert torch.equal(sg[k], se[k]), k
        assert cg == ce
        for kind, prog in eg.programs.items():
            assert prog.graph is not None and prog.replays == prog.calls - 1, kind


@pytest.mark.parametrize("heads", [(32, 8, 64), (4, 2, 16), (8, 8, 128)])
@pytest.mark.parametrize("off", [0, 17, 192, 991])
def test_prefill_tensor_q_offset_equals_int(cuda, heads, off):
    """The flash kernel reads ``q_offset`` from device memory: the same
    bits as the int form, causal and not, bf16 and f32 queries."""
    Hq, Hkv, D = heads
    g = torch.Generator(device=cuda).manual_seed(off)
    k = torch.randn(1, 1024, Hkv, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, 1024, Hkv, D, generator=g, device=cuda).bfloat16()
    dev_off = torch.tensor([off], dtype=torch.int32, device=cuda)
    for sq in (1, 5, 32):
        q = torch.randn(1, sq, Hq, D, generator=g, device=cuda).bfloat16()
        for qq in (q, q.float()):
            for causal in (True, False):
                a = ops.flash_attention(qq, k, v, causal=causal, q_offset=off)
                b = ops.flash_attention(qq, k, v, causal=causal, q_offset=dev_off)
                assert torch.equal(a, b), (sq, qq.dtype, causal)


def test_prefill_tensor_q_offset_is_checked(cuda):
    q = torch.zeros(1, 4, 4, 16, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    for bad in (torch.tensor([1], device=cuda), torch.tensor([1, 2], dtype=torch.int32,
                                                             device=cuda),
                torch.tensor([1], dtype=torch.int32)):
        with pytest.raises(ValueError, match="q_offset"):
            ops.flash_attention(q, k, k, q_offset=bad)


def test_temperature_replays_draw_fresh_numbers(cuda):
    """A program that samples fixed logits (16 rows, temperature 1, top-k
    8) with a registered generator: consecutive replays draw different
    tokens, and over 512 replays each row's counts fit the row's
    distribution (chi-square over 16 x 7 degrees of freedom, bound: mean
    + 6 standard deviations), as eager draws do."""
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn(16, 512, generator=g, device=cuda) * 2
    cfg = SamplerConfig(temperature=1.0, top_k=8)
    gen = torch.Generator(device=cuda).manual_seed(1)
    prog = Program("sample", lambda inp: (sample_on_device(logits, gen, cfg),), {}, cuda,
                   graphs=True, pool=torch.cuda.graph_pool_handle(), generators=(gen,))
    n = 512
    graph_draws = torch.stack([prog()[0].clone() for _ in range(n)])
    eager_draws = torch.stack([sample_on_device(logits, gen, cfg) for _ in range(n)])
    assert prog.replays == n - 1
    assert int((graph_draws[2:] == graph_draws[1:-1]).all(dim=1).sum()) == 0
    top = torch.topk(logits, 8, dim=-1)
    probs = torch.softmax(top.values, dim=-1)
    dof = 16 * 7
    for draws in (graph_draws, eager_draws):
        counts = (draws.T[:, :, None] == top.indices[:, None, :]).sum(dim=1).float()
        assert int(counts.sum()) == 16 * n             # every draw inside the top 8
        chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
        assert chi2 < dof + 6 * (2 * dof) ** 0.5, chi2


def test_temperature_engine_replays_sample(model):
    """A temperature run through the graphs (spec windows too) completes
    as the eager run does, and its replays draw fresh tokens (no request
    repeats one token throughout)."""
    m, params = model
    prompts = [np.arange(1, 9, dtype=np.int32)] * 3
    kw = dict(sampler=SamplerConfig(temperature=1.0), schedule="hybrid", prefill_chunk=8)
    for extra in ({}, dict(spec_depth=2, draft_model=m, draft_params=params)):
        tg, eng = _serve(m, params, prompts, True, **kw, **extra)
        te, _ = _serve(m, params, prompts, False, **kw, **extra)
        assert all(len(t) == 6 for t in tg + te)
        assert all(len(set(t[1:])) > 1 for t in tg)
        assert sum(p.replays for p in eng.programs.values()) > 0


def test_failed_capture_raises(cuda):
    """A body that syncs with the host cannot be captured: the program
    raises (after its eager warm-up ran) and restores the counters."""
    x = torch.ones(4, device=cuda)

    def body(inp):
        return (x * float(x.sum()),)

    ops.reset_launch_counts()
    prog = Program("bad", body, {}, cuda, graphs=True)
    with pytest.raises(RuntimeError):
        prog()
    assert prog.graph is None
    assert ops.launch_counts() == {"decode_attention": 0, "prefill_attention": 0,
                                   "paged_decode_attention": 0, "flash_attention_bwd": 0}
