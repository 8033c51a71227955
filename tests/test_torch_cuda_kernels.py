"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips (inside its fixture)
where no GPU is visible: a CUDA kernel has no CPU mode.  This file
imports torch and the port only, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 2e-6 and bf16 2e-2, as ``tests/test_kernels.py`` holds
the Pallas kernels to their oracles; the scaled (fp8/int8) variants 1e-5
for f32 queries (dequantized values up to a few units make the scores
larger than the unit-normal cases') and 2e-2 for bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

TOL = {"float32": 2e-6, "bfloat16": 2e-2}

DECODE_CASES = [
    # (B, S, Hkv, G, D)
    (1, 16, 1, 1, 8),
    (2, 64, 2, 4, 32),
    (3, 128, 4, 8, 64),
    (2, 96, 2, 7, 16),
    (1, 33, 1, 2, 128),
    (16, 1024, 8, 4, 64),        # llama3.2-1b decode at 16 slots
    (16, 1024, 16, 1, 128),      # moonshot-v1-16b-a3b decode at 16 slots: G 1, D 128
    (16, 1024, 36, 1, 64),       # minicpm-2b: G 1, D 64, Hkv 36
    (16, 1024, 8, 3, 128),       # llama3.2-3b: G 3, D 128
    (16, 1024, 8, 7, 128),       # yi-34b: G 7, D 128
    (16, 1024, 8, 8, 128),       # internvl2-76b: G 8 (MAX_G), D 128
]
PAGED_CASES = [
    # (B, Hkv, G, D, block_size, max_blocks, lengths) — tests/test_paged.py's
    # cases, then llama3.2-1b's serve shape (bs 16, 64 blocks per row)
    (1, 1, 1, 8, 8, 2, (5,)),
    (3, 2, 4, 16, 8, 4, (5, 17, 32)),
    (2, 2, 8, 32, 16, 3, (1, 48)),
    (2, 1, 3, 16, 8, 4, (9, 25)),
    (3, 2, 4, 128, 4, 9, (0, 33, 36)),
    (16, 8, 4, 64, 16, 64, (1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                            700, 900, 1000, 1023)),
]
# the bf16 paged-hybrid serve shapes of minicpm-2b (G 1, D 64, Hkv 36),
# llama3.2-3b (G 3, D 128) and yi-34b (G 7, D 128)
WIDE_PAGED_CASES = [
    (16, 36, 1, 64, 16, 64, (1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                             700, 900, 1000, 1023)),
    (16, 8, 3, 128, 16, 64, (1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                             700, 900, 1000, 1023)),
    (16, 8, 7, 128, 16, 64, (1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                             700, 900, 1000, 1023)),
]
PREFILL_CASES = [
    # (B, Sq, Sk, Hkv, G, D, causal)
    (1, 16, 16, 1, 1, 8, True),
    (2, 32, 32, 2, 4, 16, True),
    (2, 64, 64, 2, 2, 32, True),
    (1, 32, 32, 4, 1, 64, False),
    (2, 48, 48, 2, 3, 16, True),
    (1, 100, 100, 1, 2, 128, True),
    (1, 509, 509, 16, 1, 128, True),     # moonshot-v1-16b-a3b's whole prompt
    (1, 600, 600, 16, 1, 128, False),
    (1, 509, 509, 36, 1, 64, True),      # minicpm-2b's whole prompt: G 1, D 64, Hkv 36
    (1, 509, 509, 8, 3, 128, True),      # llama3.2-3b: G 3, D 128
    (1, 509, 509, 8, 7, 128, True),      # yi-34b: G 7, D 128
    (1, 765, 765, 8, 8, 128, True),      # internvl2-76b: 256 frontend positions + a prompt
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _randn(rng, shape, dev, dtype):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    B, S, Hkv, G, D = case
    rng = np.random.default_rng(B * S)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, Hkv * G, D), cuda, dt)
    k = _randn(rng, (B, S, Hkv, D), cuda, dt)
    v = _randn(rng, (B, S, Hkv, D), cuda, dt)
    lengths = torch.from_numpy(rng.integers(1, S + 1, size=B).astype(np.int32)).to(cuda)
    lengths[0] = S + 7                   # past the cache: clamped to S
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    exp = ref.naive_decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype], rtol=TOL[dtype])


# llama3.2-1b's serve shape, then its placed shards' heads (Hkv 4 on a
# model axis of 2, Hkv 2 on one of 4), at a window of S/2 and S/4 of the
# positions (the sequence policies' windows)
DECODE_LSE_CASES = [(16, S, Hkv, 4, 64) for Hkv in (8, 4, 2) for S in (1024, 512, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_LSE_CASES)
def test_decode_kernel_lse_matches_plain(cuda, case, dtype):
    """``return_lse``: out and the f32 lse (B, Hkv, G) equal the plain
    version's at every split plan the shape takes; rows of length 0 (a
    window the row has not reached) give out 0 and lse <= -1e30; the lse
    launch counts as variant ``lse``."""
    B, S, Hkv, G, D = case
    rng = np.random.default_rng(S + Hkv)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, Hkv * G, D), cuda, dt)
    k = _randn(rng, (B, S, Hkv, D), cuda, dt)
    v = _randn(rng, (B, S, Hkv, D), cuda, dt)
    lengths = torch.from_numpy(rng.integers(1, S + 1, size=B).astype(np.int32)).to(cuda)
    lengths[:3] = torch.tensor([0, S + 9, 1], dtype=torch.int32)
    before = ops.variant_counts()["decode_attention"].get("lse", 0)
    out, lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
    torch.cuda.synchronize()
    assert ops.variant_counts()["decode_attention"]["lse"] == before + 1
    assert lse.shape == (B, Hkv, G) and lse.dtype == torch.float32
    exp, exp_lse = ref.naive_decode_attention(q, k, v, lengths, return_lse=True)
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(_np(lse)[1:], _np(exp_lse)[1:], atol=1e-3, rtol=1e-4)
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30
    assert not out.isnan().any() and not lse.isnan().any()


def test_decode_kernel_lse_windows_merge_to_the_whole_cache(cuda):
    """The kernel over each quarter of llama's serve cache, merged by
    ``ref.lse_merge``, equals the kernel over the whole cache."""
    rng = np.random.default_rng(4)
    B, S, Hkv, G, D = 16, 1024, 8, 4, 64
    q = _randn(rng, (B, Hkv * G, D), cuda, torch.bfloat16)
    k = _randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16)
    v = _randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16)
    lengths = torch.from_numpy(rng.integers(1, S + 1, size=B).astype(np.int32)).to(cuda)
    parts = []
    for s0 in range(0, S, S // 4):
        win = (lengths - s0).clamp(0, S // 4)
        parts.append(ops.decode_attention(q, k[:, s0:s0 + S // 4], v[:, s0:s0 + S // 4], win,
                                          return_lse=True))
    whole = ops.decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(_np(ref.lse_merge(parts)), _np(whole), atol=2e-2, rtol=2e-2)


def test_decode_kernel_reads_strided_cache(cuda):
    """One layer of a stacked (L, B, S, Hkv, D) cache, and a zero length."""
    rng = np.random.default_rng(0)
    cache = _randn(rng, (3, 4, 40, 2, 16), cuda, torch.bfloat16)
    q = _randn(rng, (4, 8, 16), cuda, torch.bfloat16)
    lengths = torch.tensor([0, 1, 17, 40], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, cache[1], cache[2], lengths)
    exp = ref.naive_decode_attention(q, cache[1], cache[2], lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, Hkv, G, D, causal = case
    rng = np.random.default_rng(Sq)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, Sq, Hkv * G, D), cuda, dt)
    k = _randn(rng, (B, Sk, Hkv, D), cuda, dt)
    v = _randn(rng, (B, Sk, Hkv, D), cuda, dt)
    before = ops.launch_counts()["prefill_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["prefill_attention"] == before + 1
    exp = ref.naive_attention(q, k, v, causal=causal, q_offset=0)
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("sq,off", [(37, 0), (37, 17), (509, 0), (16, 32), (5, 0)])
def test_prefill_kernel_ragged_and_offset(cuda, sq, off):
    """Lengths no block divides, and q_offset != 0, at llama3.2-1b's heads."""
    rng = np.random.default_rng(sq + off)
    q = _randn(rng, (1, sq, 32, 64), cuda, torch.bfloat16)
    k = _randn(rng, (1, sq + off, 8, 64), cuda, torch.bfloat16)
    v = _randn(rng, (1, sq + off, 8, 64), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, q_offset=off)
    exp = ref.naive_attention(q, k, v, q_offset=off)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros(2, 4, 16, device=cuda, dtype=torch.float16)
    k = torch.zeros(2, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32, device=cuda))
    x = torch.zeros(1, 4, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(x[:, :, :, :4].contiguous(), x, x)


def test_scaled_flash_kernel_rejects_bad_scales(cuda):
    """Scales only in pairs, only f32, only with 1-byte K/V, in the
    (B, Sk, Hkv) layout."""
    q = torch.zeros(1, 4, 4, 16, device=cuda)
    k = torch.zeros(1, 4, 2, 16, device=cuda, dtype=torch.int8)
    s = torch.ones(1, 4, 2, device=cuda)
    with pytest.raises(ValueError, match="both"):
        ops.flash_attention(q, k, k, k_scale=s)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention(q, k, k, k_scale=s.bfloat16(), v_scale=s.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, k, k, k_scale=s[:, :2], v_scale=s[:, :2])
    with pytest.raises(ValueError, match="need"):
        ops.flash_attention(q, k, k)                       # int8 K/V without scales
    with pytest.raises(ValueError, match="take no"):
        ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(),
                            k_scale=s, v_scale=s)


def test_decode_kernel_f32_queries_over_bf16_cache(cuda):
    """float32 mode: f32 activations attend over the bf16 cache."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (4, 8, 64), cuda, torch.float32)
    k = _randn(rng, (4, 50, 2, 64), cuda, torch.bfloat16)
    v = _randn(rng, (4, 50, 2, 64), cuda, torch.bfloat16)
    lengths = torch.tensor([1, 20, 50, 60], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lengths)
    assert out.dtype == torch.float32
    exp = ref.naive_decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


def _paged_inputs(case, dev, dtype, q_dtype=None, seed=0):
    """Scrambled tables (null block 0 for unused entries), garbage in
    block 0; lengths past the table are clamped by the kernel."""
    B, Hkv, G, D, bs, MB, lens = case
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    q = _randn(rng, (B, Hkv * G, D), dev, q_dtype or dtype)
    kp = _randn(rng, (N, Hkv, bs, D), dev, dtype)
    vp = _randn(rng, (N, Hkv, bs, D), dev, dtype)
    kp[0], vp[0] = 99.0, -99.0
    perm = iter(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        for j in range(min(-(-int(lens[b]) // bs), MB)):
            tables[b, j] = next(perm)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, torch.from_numpy(tables).to(dev), lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES + WIDE_PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, tables, lengths = _paged_inputs(case, cuda, getattr(torch, dtype))
    before = ops.launch_counts()["paged_decode_attention"]
    out = ops.paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    exp = ref.paged_decode_attention(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", PAGED_CASES[1:] + WIDE_PAGED_CASES)
def test_paged_kernel_window_and_lse(cuda, case):
    """``starts`` masks a prefix (including whole blocks below it and an
    empty window); the lse equals the oracle's."""
    q, kp, vp, tables, lengths = _paged_inputs(case, cuda, torch.bfloat16, seed=1)
    starts = (lengths // 3).to(torch.int32)
    starts[0] = lengths[0] + 2                 # empty window: out 0, lse <= -1e30
    out, lse = ops.paged_decode_attention(q, kp, vp, tables, lengths, starts=starts,
                                          return_lse=True)
    exp, exp_lse = ref.paged_decode_attention(q, kp, vp, tables, lengths, starts=starts,
                                              return_lse=True)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(lse)[1:], _np(exp_lse)[1:], atol=1e-3, rtol=1e-4)
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30


def test_paged_kernel_f32_queries_over_bf16_pool(cuda):
    """float32 mode: f32 activations attend over the bf16 pool."""
    q, kp, vp, tables, lengths = _paged_inputs(PAGED_CASES[1], cuda, torch.bfloat16,
                                               q_dtype=torch.float32, seed=2)
    out = ops.paged_decode_attention(q, kp, vp, tables, lengths)
    assert out.dtype == torch.float32
    exp = ref.paged_decode_attention(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


def test_paged_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 18, 16, device=cuda)                 # G = 9 > 8
    pool = torch.zeros(5, 2, 128, 16, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, pool, pool, tables, lengths)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, pool[:, :, :8], pool[:, :, :8], tables.long(),
                                   lengths)



def test_scaled_paged_kernel_rejects_bad_scales(cuda):
    """Scale pools only in pairs, only f32, only for an fp8/int8 pool, of
    shape (N, Hkv, bs)."""
    q = torch.zeros(2, 4, 16, device=cuda)
    pool = torch.zeros(5, 2, 8, 16, device=cuda).to(torch.float8_e4m3fn)
    s = torch.ones(5, 2, 8, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="both"):
        ops.paged_decode_attention(q, pool, pool, tables, lengths, v_scale=s)
    with pytest.raises(TypeError, match="float32"):
        ops.paged_decode_attention(q, pool, pool, tables, lengths, k_scale=s.double(),
                                   v_scale=s.double())
    with pytest.raises(ValueError, match="shape"):
        ops.paged_decode_attention(q, pool, pool, tables, lengths, k_scale=s[:4],
                                   v_scale=s[:4])
    with pytest.raises(ValueError, match="needs"):
        ops.paged_decode_attention(q, pool, pool, tables, lengths)
    with pytest.raises(ValueError, match="takes no"):
        ops.paged_decode_attention(q, pool.float(), pool.float(), tables, lengths,
                                   k_scale=s, v_scale=s)


@pytest.mark.parametrize("sq,sk,off", [(16, 64, 0), (8, 64, 29), (37, 40, 3)])
def test_prefill_kernel_f32_queries_over_bf16_cache(cuda, sq, sk, off):
    """float32 mode's chunked prefill: f32 queries attend a bf16 cache
    stripe at a q_offset."""
    rng = np.random.default_rng(sq + off)
    q = _randn(rng, (1, sq, 8, 64), cuda, torch.float32)
    k = _randn(rng, (1, sk, 2, 64), cuda, torch.bfloat16)
    v = _randn(rng, (1, sk, 2, 64), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, q_offset=off)
    assert out.dtype == torch.float32
    exp = ref.naive_attention(q, k, v, q_offset=off)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


def _quantized(x: torch.Tensor, kv: str):
    return ref.kv_quantize(x * 3, kv)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["fp8", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES[1:])
def test_scaled_paged_kernel_matches_plain(cuda, case, kv, q_dtype):
    """fp8/int8 pools with their scale pools (garbage in null block 0 of
    both), plain and with a ``starts`` window + lse (row 0's window
    empty)."""
    dt = getattr(torch, q_dtype)
    q, kp, vp, tables, lengths = _paged_inputs(case, cuda, torch.float32, q_dtype=dt,
                                               seed=3)
    (kq, ks), (vq, vs) = _quantized(kp, kv), _quantized(vp, kv)
    ks[0], vs[0] = 7.5, -3.0
    tol = 1e-5 if q_dtype == "float32" else 2e-2
    before = ops.variant_counts()["paged_decode_attention"].get(kv, 0)
    out = ops.paged_decode_attention(q, kq, vq, tables, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert ops.variant_counts()["paged_decode_attention"][kv] == before + 1
    exp = ref.paged_decode_attention(q, kq, vq, tables, lengths, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)
    starts = (lengths // 3).to(torch.int32)
    starts[0] = lengths[0] + 2
    out, lse = ops.paged_decode_attention(q, kq, vq, tables, lengths, starts=starts,
                                          return_lse=True, k_scale=ks, v_scale=vs)
    exp, exp_lse = ref.paged_decode_attention(q, kq, vq, tables, lengths, starts=starts,
                                              return_lse=True, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse)[1:], _np(exp_lse)[1:], atol=1e-3, rtol=1e-4)
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_scaled_paged_kernel_zero_vectors_dequantize_to_zero(cuda, kv):
    """An all-zero V has payload 0 and scale 0: the output is exactly 0."""
    q, kp, vp, tables, lengths = _paged_inputs(PAGED_CASES[1], cuda, torch.float32, seed=4)
    (kq, ks), (vq, vs) = _quantized(kp, kv), _quantized(torch.zeros_like(vp), kv)
    assert float(vs.abs().max()) == 0.0
    out = ops.paged_decode_attention(q, kq, vq, tables, lengths, k_scale=ks, v_scale=vs)
    assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["fp8", "int8"])
@pytest.mark.parametrize("sq,off,causal", [(37, 0, True), (16, 29, True), (48, 0, False)])
def test_scaled_flash_kernel_matches_plain(cuda, sq, off, causal, kv, q_dtype):
    """int8/fp8 K/V with (B, Sk, Hkv) f32 scales at llama3.2-1b's heads,
    ragged lengths and a q_offset; one scale tensor read through
    non-contiguous strides (a transposed (B, Hkv, Sk) buffer)."""
    dt = getattr(torch, q_dtype)
    rng = np.random.default_rng(sq + off)
    q = _randn(rng, (2, sq, 8, 64), cuda, dt)
    (kq, ks), (vq, vs) = (_quantized(_randn(rng, (2, sq + off, 2, 64), cuda, torch.float32),
                                     kv) for _ in range(2))
    ks_t = ks.transpose(1, 2).contiguous().transpose(1, 2)      # same values, other strides
    vs_t = vs.transpose(1, 2).contiguous().transpose(1, 2)
    tol = 1e-5 if q_dtype == "float32" else 2e-2
    before = ops.variant_counts()["prefill_attention"].get(kv, 0)
    out = ops.flash_attention(q, kq, vq, causal=causal, q_offset=off, k_scale=ks_t,
                              v_scale=vs_t)
    torch.cuda.synchronize()
    assert ops.variant_counts()["prefill_attention"][kv] == before + 1
    exp = ref.naive_attention(q, kq, vq, causal=causal, q_offset=off, k_scale=ks,
                              v_scale=vs)
    np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)


# ---- the split decode kernel and the tensor-core prefill kernel ----------
def _split_lengths(S: int, split: int) -> list[int]:
    """0, 1, a span boundary and its neighbours, S and past S."""
    return [0, 1, split - 1, split, split + 1, 2 * split + 1, S, S + 9]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hkv,G,D", [(8, 1024, 8, 4, 64), (8, 512, 1, 2, 128),
                                         (8, 300, 2, 8, 16), (8, 1024, 16, 1, 128)])
def test_decode_kernel_split_boundaries(cuda, B, S, Hkv, G, D, dtype):
    """Lengths at, one below and one above a span boundary of the split
    the wrapper plans, with 0, 1, S and past S in the same batch."""
    from repro_torch.kernels import decode_attention as kdec

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split, n_split = kdec.plan_split(S, B * Hkv, sms)
    assert n_split > 1
    rng = np.random.default_rng(S + D)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, Hkv * G, D), cuda, dt)
    k = _randn(rng, (B, S, Hkv, D), cuda, dt)
    v = _randn(rng, (B, S, Hkv, D), cuda, dt)
    lengths = torch.tensor(_split_lengths(S, split), dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    exp = ref.naive_decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype], rtol=TOL[dtype])
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_prefill_kernel_gqa_packing(cuda, G):
    """(query, head) rows packed per KV head, for G heads per KV head;
    Sq * G is no multiple of the 64-row tile."""
    rng = np.random.default_rng(G)
    q = _randn(rng, (2, 45, 2 * G, 64), cuda, torch.bfloat16)
    k = _randn(rng, (2, 52, 2, 64), cuda, torch.bfloat16)
    v = _randn(rng, (2, 52, 2, 64), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, q_offset=7)
    exp = ref.naive_attention(q, k, v, q_offset=7)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("off", [0, 17, 192, 991])
@pytest.mark.parametrize("sq", [1, 5, 32])
def test_prefill_kernel_chunk_shape(cuda, sq, off):
    """The hybrid schedule's chunk: Sq <= 32 queries at a q_offset against
    the 1024-position staging stripe (keys past q_offset + Sq hold data
    the causal mask must hide), llama3.2-1b's heads."""
    rng = np.random.default_rng(sq * 1000 + off)
    q = _randn(rng, (1, sq, 32, 64), cuda, torch.bfloat16)
    k = _randn(rng, (1, 1024, 8, 64), cuda, torch.bfloat16)
    v = _randn(rng, (1, 1024, 8, 64), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, q_offset=off)
    exp = ref.naive_attention(q, k, v, q_offset=off)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [8, 16, 64, 128])
def test_prefill_kernel_tensor_core_head_dims(cuda, D, causal):
    """bf16 queries on the tensor-core path at head dims padded to the
    mma's contraction (8 and 16 to 32) and at its full 128."""
    rng = np.random.default_rng(D)
    q = _randn(rng, (2, 70, 8, D), cuda, torch.bfloat16)
    k = _randn(rng, (2, 81, 2, D), cuda, torch.bfloat16)
    v = _randn(rng, (2, 81, 2, D), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=causal, q_offset=11)
    exp = ref.naive_attention(q, k, v, causal=causal, q_offset=11)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_scaled_flash_kernel_zero_vectors_dequantize_to_zero(cuda, kv):
    """A zero V has payload 0 and scale 0: the output is exactly 0.  Zero
    K vectors score exactly 0 (an all-zero K gives the mean of V)."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (1, 40, 8, 64), cuda, torch.bfloat16)
    x = _randn(rng, (1, 40, 2, 64), cuda, torch.float32)
    (kq, ks), (zq, zs) = _quantized(x, kv), _quantized(torch.zeros_like(x), kv)
    assert float(zs.abs().max()) == 0.0
    out = ops.flash_attention(q, kq, zq, k_scale=ks, v_scale=zs)
    assert float(out.abs().max()) == 0.0
    out = ops.flash_attention(q, zq, kq, k_scale=zs, v_scale=ks)
    exp = ref.naive_attention(q, zq, kq, k_scale=zs, v_scale=ks)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 2e-6), ("bfloat16", 1e-5)])
def test_prefill_kernel_f32_queries_keep_f32_accuracy(cuda, kv_dtype, tol):
    """f32 queries run the f32-FMA kernel: at a whole-prompt length and at
    the chunk shape they meet float32 mode's tolerances."""
    rng = np.random.default_rng(9)
    for sq, sk, off in ((200, 200, 0), (32, 1024, 192)):
        q = _randn(rng, (1, sq, 8, 64), cuda, torch.float32)
        k = _randn(rng, (1, sk, 2, 64), cuda, getattr(torch, kv_dtype))
        v = _randn(rng, (1, sk, 2, 64), cuda, getattr(torch, kv_dtype))
        out = ops.flash_attention(q, k, v, q_offset=off)
        assert out.dtype == torch.float32
        exp = ref.naive_attention(q, k, v, q_offset=off)
        np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)


# ---- the split paged decode kernels --------------------------------------
PAGED_SPLIT_SHAPES = [
    # (B, Hkv, G, D, block_size, max_blocks, (split, n_split) planned on an H100)
    (16, 8, 4, 64, 16, 64, (256, 4)),      # llama3.2-1b serve: 4 spans, merge kernel
    (4, 2, 8, 128, 8, 8, (64, 1)),         # one span: the CTA writes out and lse
]
POOL_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "fp8": None, "int8": None}


def _split_edges(B: int, cap: int, split: int, bs: int):
    """Lengths and starts at span edges (and one off), block edges, 0, the
    table's end and past it."""
    lens = [0, 1, split - 1, split, split + 1, 2 * split - 1, 2 * split + 1, bs, bs + 1,
            cap - 1, cap, cap + 9, 3 * split, 3 * split + bs - 1, bs - 1, 2 * split]
    starts = [0, 0, bs, split, split, split - 1, 2 * split, bs, bs, split + bs, split - bs,
              2 * split, 2 * split + 1, 3 * split, 0, 2 * split]
    return ([min(n, cap + 9) for n in lens[:B]], [min(s, cap) for s in starts[:B]])


def _pool(rng, shape, dev, kind):
    """A pool of ``kind`` (bf16/f32, or fp8/int8 payloads of 3x unit-normal
    data with their (N, Hkv, bs) scales)."""
    x = _randn(rng, shape, dev, torch.float32)
    if POOL_DTYPES[kind] is not None:
        return x.to(POOL_DTYPES[kind]), None
    return _quantized(x, kind)


def _paged_tol(q_dtype: str, kind: str) -> float:
    if q_dtype == "bfloat16":
        return 2e-2
    return 2e-6 if kind == "float32" else 1e-5


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", list(POOL_DTYPES))
@pytest.mark.parametrize("shape", PAGED_SPLIT_SHAPES, ids=["serve", "one-span"])
def test_paged_split_kernel_span_and_block_edges(cuda, shape, kind, q_dtype):
    """Lengths and ``starts`` at span boundaries (and one either side),
    block edges, 0 and past the table, for every pool type and both query
    types; out and lse against the plain version."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_decode_attention as kpaged

    B, Hkv, G, D, bs, MB, want = shape
    sms = kdec.sm_count(cuda)
    assert kpaged.plan(MB, bs, B, Hkv, sms) == want
    split = want[0]
    lens, starts = _split_edges(B, MB * bs, split, bs)
    case = (B, Hkv, G, D, bs, MB, lens)
    rng = np.random.default_rng(B * D)
    q, _, _, tables, lengths = _paged_inputs(case, cuda, torch.float32,
                                             q_dtype=getattr(torch, q_dtype), seed=B)
    N = tables.shape[0] * MB + 1
    (kp, ks), (vp, vs) = (_pool(rng, (N, Hkv, bs, D), cuda, kind) for _ in range(2))
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    tol = _paged_tol(q_dtype, kind)
    for st in (None, starts):
        before = ops.launch_counts()["paged_decode_attention"]
        out, lse = ops.paged_decode_attention(q, kp, vp, tables, lengths, starts=st,
                                              return_lse=True, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert ops.launch_counts()["paged_decode_attention"] == before + 1
        exp, exp_lse = ref.paged_decode_attention(q, kp, vp, tables, lengths, starts=st,
                                                  return_lse=True, k_scale=ks, v_scale=vs)
        np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)
        live = _np(exp_lse)[:, 0, 0] > -1e29                   # rows whose window is not empty
        np.testing.assert_allclose(_np(lse)[live], _np(exp_lse)[live], atol=1e-3, rtol=1e-4)
        assert np.all(_np(lse)[~live] <= -1e30) and np.all(_np(out)[~live] == 0)


def _poison(pool, spool, tables, lengths, bs, nan: bool):
    """Copies of a pool and its scales with null block 0 and every
    position past its row's length inside a live block set to NaN (``nan``;
    an fp8 payload of 0x7F, an int8 payload of 127 with a NaN scale) or
    to zeros."""
    pool, spool = pool.clone(), None if spool is None else spool.clone()
    if pool.dtype == torch.float8_e4m3fn:
        fill = 0x7F if nan else 0                                # e4m3fn NaN: S.1111.111
    elif pool.dtype == torch.int8:
        fill = 127 if nan else 0                                 # no NaN: the scale carries it
    else:
        fill = float("nan") if nan else 0.0
    sfill = float("nan") if nan else 0.0
    rows = ref.byte_view(pool)
    rows[0] = fill
    if spool is not None:
        spool[0] = sfill
    for b, n in enumerate(lengths.tolist()):
        if 0 < n < tables.shape[1] * bs and n % bs:
            blk = int(tables[b, n // bs])
            rows[blk, :, n % bs:] = fill
            if spool is not None:
                spool[blk, :, n % bs:] = sfill
    return pool, spool


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["bfloat16", "fp8", "int8"])
def test_paged_split_kernel_never_reads_garbage(cuda, kind, q_dtype):
    """NaN in null block 0 and past each row's length inside its last live
    block (an fp8 payload of 0x7F; an int8 pool's NaN in its scales): the
    output is finite and equals the plain version on the same pool with
    zeros there."""
    B, Hkv, G, D, bs, MB = 16, 8, 4, 64, 16, 64
    case = (B, Hkv, G, D, bs, MB, (1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513,
                                   700, 900, 1000, 1023))
    rng = np.random.default_rng(11)
    q, _, _, tables, lengths = _paged_inputs(case, cuda, torch.float32,
                                             q_dtype=getattr(torch, q_dtype), seed=11)
    N = B * MB + 1
    (kp, ks), (vp, vs) = (_pool(rng, (N, Hkv, bs, D), cuda, kind) for _ in range(2))
    (kd, ksd), (vd, vsd) = (_poison(p, s, tables, lengths, bs, nan=True)
                            for p, s in ((kp, ks), (vp, vs)))
    (kc, ksc), (vc, vsc) = (_poison(p, s, tables, lengths, bs, nan=False)
                            for p, s in ((kp, ks), (vp, vs)))
    starts = (lengths // 3).to(torch.int32)
    for st in (None, starts):
        out = ops.paged_decode_attention(q, kd, vd, tables, lengths, starts=st, k_scale=ksd,
                                         v_scale=vsd)
        exp = ref.paged_decode_attention(q, kc, vc, tables, lengths, starts=st, k_scale=ksc,
                                         v_scale=vsc)
        assert torch.isfinite(out).all()
        tol = _paged_tol(q_dtype, kind)
        np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", list(POOL_DTYPES))
def test_paged_split_kernel_all_windows_empty(cuda, kind, q_dtype):
    """The cold launch of a step with nothing spilled: every row's length
    0 (and, second, every window starting at its length).  Out exactly 0,
    lse <= -1e30, no NaN."""
    B, Hkv, G, D, bs, MB = 16, 8, 4, 64, 16, 64
    case = (B, Hkv, G, D, bs, MB, tuple(range(0, 16 * 61, 61)))
    rng = np.random.default_rng(12)
    q, _, _, tables, lengths = _paged_inputs(case, cuda, torch.float32,
                                             q_dtype=getattr(torch, q_dtype), seed=12)
    (kp, ks), (vp, vs) = (_pool(rng, (B * MB + 1, Hkv, bs, D), cuda, kind) for _ in range(2))
    for n, st in ((torch.zeros_like(lengths), None), (lengths, lengths)):
        out, lse = ops.paged_decode_attention(q, kp, vp, tables, n, starts=st,
                                              return_lse=True, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert float(out.abs().max()) == 0.0
        assert float(lse.max()) <= -1e30 and not torch.isnan(lse).any()


# ------------------------------------------------------ speculative decoding
# The draft of ``--spec-depth`` (reduced llama3.2-1b: Hq 4, Hkv 2, D 16)
# runs the dense decode and the chunk prefill at its own shapes; the paged
# kernel runs at any ``--block-size``; the verify writes a window past the
# table to null block 0.


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_decode_kernel_at_the_draft_shape(cuda, q_dtype):
    """16 slots, S 1024, Hkv 2, G 2, D 16 (the tensor-core kernel pads D to
    32), ragged lengths, one past the cache."""
    B, S, Hkv, G, D = 16, 1024, 2, 2, 16
    rng = np.random.default_rng(16)
    q = _randn(rng, (B, Hkv * G, D), cuda, getattr(torch, q_dtype))
    k = _randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16)
    v = _randn(rng, (B, S, Hkv, D), cuda, torch.bfloat16)
    lengths = torch.tensor([1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700,
                            900, 1000, 0], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lengths)
    exp = ref.naive_decode_attention(q, k, v, lengths)
    tol = 2e-2 if q_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(out), _np(exp), atol=tol, rtol=tol)


@pytest.mark.parametrize("off", [0, 32, 192, 992])
def test_prefill_kernel_at_the_draft_chunk_shape(cuda, off):
    """The draft's chunked prefill: 32 queries, Hq 4, Hkv 2, D 16, at
    ``q_offset`` running over the prompt, against a 1024-position stripe."""
    rng = np.random.default_rng(off)
    q = _randn(rng, (1, 32, 4, 16), cuda, torch.bfloat16)
    k = _randn(rng, (1, 1024, 2, 16), cuda, torch.bfloat16)
    v = _randn(rng, (1, 1024, 2, 16), cuda, torch.bfloat16)
    out = ops.flash_attention(q, k, v, q_offset=off)
    exp = ref.naive_attention(q, k, v, q_offset=off)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", ["bfloat16", "fp8"])
@pytest.mark.parametrize("bs", [128, 256, 48])
def test_paged_kernel_block_sizes_over_64(cuda, bs, kind):
    """Block sizes over 64 (and one that is no power of two), llama3.2-1b's
    heads, 16 rows over 8 blocks each: lengths at block edges and past the
    table, a ``starts`` window with its lse, NaN in null block 0 and past
    each row's length (never read), and every window empty."""
    B, Hkv, G, D, MB = 16, 8, 4, 64, 8
    cap = MB * bs
    lens = [0, 1, bs - 1, bs, bs + 1, 2 * bs, 3 * bs - 5, cap - 1, cap, cap + 7, 5 * bs + 3,
            bs // 2, 7 * bs + 1, 4 * bs, 6 * bs - 1, 2]
    case = (B, Hkv, G, D, bs, MB, lens)
    rng = np.random.default_rng(bs)
    q, _, _, tables, lengths = _paged_inputs(case, cuda, torch.float32,
                                             q_dtype=torch.bfloat16, seed=bs)
    N = B * MB + 1
    (kp, ks), (vp, vs) = (_pool(rng, (N, Hkv, bs, D), cuda, kind) for _ in range(2))
    starts = (lengths // 3).to(torch.int32)
    out, lse = ops.paged_decode_attention(q, kp, vp, tables, lengths, starts=starts,
                                          return_lse=True, k_scale=ks, v_scale=vs)
    exp, exp_lse = ref.paged_decode_attention(q, kp, vp, tables, lengths, starts=starts,
                                              return_lse=True, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)
    live = _np(exp_lse)[:, 0, 0] > -1e29
    np.testing.assert_allclose(_np(lse)[live], _np(exp_lse)[live], atol=1e-3, rtol=1e-4)
    (kd, ksd), (vd, vsd) = (_poison(p, s, tables, lengths, bs, nan=True)
                            for p, s in ((kp, ks), (vp, vs)))
    (kc, ksc), (vc, vsc) = (_poison(p, s, tables, lengths, bs, nan=False)
                            for p, s in ((kp, ks), (vp, vs)))
    out_n = ops.paged_decode_attention(q, kd, vd, tables, lengths, k_scale=ksd, v_scale=vsd)
    exp_n = ref.paged_decode_attention(q, kc, vc, tables, lengths, k_scale=ksc, v_scale=vsc)
    assert torch.isfinite(out_n).all()
    np.testing.assert_allclose(_np(out_n), _np(exp_n), atol=2e-2, rtol=2e-2)
    out_e, lse_e = ops.paged_decode_attention(q, kp, vp, tables, torch.zeros_like(lengths),
                                              return_lse=True, k_scale=ks, v_scale=vs)
    assert float(out_e.abs().max()) == 0.0 and float(lse_e.max()) <= -1e30


def test_paged_verify_window_across_a_block_edge_and_past_the_table(cuda):
    """Reduced llama3.2-1b in float32, ``paged_verify_step`` over a bf16
    pool on the GPU against the CPU, same weights: slot 0's window of 3
    crosses a block edge, slot 1's runs past its table.  Logits within
    5e-2 (the plain decode rounds p to bf16, the kernels do not); lengths
    unchanged; the writes land in the addressed blocks and in null block
    0, and no other block changes."""
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models.registry import build_model

    cfg = reduce_config("llama3.2-1b").with_overrides(dtype="float32")
    gpu, cpu = build_model(cfg, cuda), build_model(cfg, "cpu")
    p_gpu = gpu.init(seed=3)
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
             for k, v in p_gpu.items()}
    bs, N = 4, 10
    tables = torch.tensor([[3, 7, 0], [5, 2, 9]], dtype=torch.int32)
    lengths = torch.tensor([3, 11], dtype=torch.int32)
    rng = np.random.default_rng(9)
    pool = {key: torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, N, cfg.n_kv_heads, bs, cfg.resolved_head_dim()), np.float32)
    ).bfloat16() for key in ("k", "v")}
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 3)).astype(np.int32))
    outs = []
    for model, params, dev in ((gpu, p_gpu, cuda), (cpu, p_cpu, torch.device("cpu"))):
        cache = model.init_paged_cache(2, N, bs, 3)
        for key in ("k", "v"):
            cache[key].copy_(pool[key])
        cache["block_tables"].copy_(tables)
        cache["lengths"].copy_(lengths)
        logits, cache = model.paged_verify_step(params, cache, toks.to(dev))
        outs.append((logits.cpu(), {k: v.cpu() for k, v in cache.items()}))
    (lg, cg), (lc, cc) = outs
    np.testing.assert_allclose(_np(lg), _np(lc), atol=5e-2, rtol=5e-2)
    assert cg["lengths"].tolist() == [3, 11]
    for key in ("k", "v"):
        changed = {int(b) for b in torch.nonzero(
            (cg[key] != pool[key]).flatten(2).any(-1).any(0)).flatten()}
        assert changed == {0, 3, 7, 9}, (key, changed)
        np.testing.assert_allclose(_np(cg[key][:, 1:]), _np(cc[key][:, 1:]), atol=2e-2,
                                   rtol=2e-2)


# ------------------------------------------------ training: lse + backward
BWD_CASES = [
    # (B, S, Hkv, G, D): llama3.2-1b's and minicpm-2b's training shapes,
    # then causal edges with S not a multiple of the 64-row block
    (8, 1024, 8, 4, 64),
    (2, 1024, 36, 1, 64),
    (2, 100, 2, 4, 64),
    (1, 130, 1, 8, 128),
    (3, 37, 2, 2, 16),
    (1, 65, 4, 1, 32),
    # the 128-row CTAs' edges: S not a multiple of 128 or under one 64-row
    # tile; G 3 and 7, whose flat (head, query tile) loop crosses head
    # boundaries inside the ring; D 16 / 32 / 64 / 128 and D not a
    # multiple of 16 (40, 120: zero-padded contraction columns)
    (1, 1000, 2, 3, 64),
    (2, 191, 1, 7, 128),
    (1, 129, 3, 2, 32),
    (2, 17, 2, 7, 16),
    (1, 257, 2, 3, 40),
    (1, 150, 1, 4, 120),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}       # of max(1, |plain|)
# ||kernel - plain|| / ||plain|| of each bf16 gradient: bf16 rounding of P,
# dS and the outputs reads a few 1e-3; a wrong delta or lse reads 1e-1
BWD_REL_NORM_TOL = 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_lse_and_backward_match_plain(cuda, case, dtype):
    """The forward's lse against the plain ``logsumexp(scale * q k^T)``
    (1e-4: f32 in both), its output bit-equal to the launch without lse,
    and dq, dk, dv against the plain backward from the same saved tensors,
    each within the tolerance of max(1, |plain|) (and, in bf16, within
    ``BWD_REL_NORM_TOL`` in norm); two launches give the same bits (no
    atomics)."""
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import prefill_attention as kpre

    B, S, Hkv, G, D = case
    if dtype == "float32" and B * S * Hkv * G > 200_000:
        B = 1                                   # the f32 FMA kernels at a smaller batch
    rng = np.random.default_rng(S + G)
    dt = getattr(torch, dtype)
    q, do = (_randn(rng, (B, S, Hkv * G, D), cuda, dt) for _ in range(2))
    k, v = (_randn(rng, (B, S, Hkv, D), cuda, dt) for _ in range(2))
    out, lse = kpre.kernel(q, k, v, return_lse=True)
    assert torch.equal(out, kpre.kernel(q, k, v))
    np.testing.assert_allclose(_np(lse), _np(ref.attention_lse(q, k)), atol=1e-4, rtol=1e-5)
    got = kbwd.kernel(q, k, v, out, do, lse)
    again = kbwd.kernel(q, k, v, out, do, lse)
    want = kbwd.plain(q, k, v, out, do, lse)
    for a, b, c in zip(got, again, want):
        assert a.dtype == dt and torch.equal(a, b)
        err = ((a.float() - c.float()).abs() / c.float().abs().clamp_min(1)).max()
        assert float(err) <= BWD_TOL[dtype], float(err)
        if dtype == "bfloat16":
            rel = (a.float() - c.float()).norm() / c.float().norm()
            assert float(rel) <= BWD_REL_NORM_TOL, float(rel)


def test_flash_attention_fn_gradient_through_autograd(cuda):
    """``ops.FlashAttentionFn`` under autograd launches the lse forward
    once and the backward once, and its gradients are the backward
    kernel's."""
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import prefill_attention as kpre

    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 200, 8, 64), cuda, torch.bfloat16).requires_grad_()
    k = _randn(rng, (2, 200, 2, 64), cuda, torch.bfloat16).requires_grad_()
    v = _randn(rng, (2, 200, 2, 64), cuda, torch.bfloat16).requires_grad_()
    do = _randn(rng, (2, 200, 8, 64), cuda, torch.bfloat16)
    ops.reset_launch_counts()
    out = ops.FlashAttentionFn.apply(q, k, v, None)
    out.backward(do)
    assert ops.variant_counts()["prefill_attention"] == {"lse": 1}
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    o, lse = kpre.kernel(q.detach(), k.detach(), v.detach(), return_lse=True)
    for g, w in zip((q.grad, k.grad, v.grad), kbwd.kernel(q.detach(), k.detach(), v.detach(),
                                                          o, do, lse)):
        assert torch.equal(g, w)
