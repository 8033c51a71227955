"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips (inside its fixture)
where no GPU is visible: a CUDA kernel has no CPU mode.  This file
imports torch and the port only, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 2e-6 and bf16 2e-2, as ``tests/test_kernels.py`` holds
the Pallas kernels to their oracles.
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
]
PREFILL_CASES = [
    # (B, Sq, Sk, Hkv, G, D, causal)
    (1, 16, 16, 1, 1, 8, True),
    (2, 32, 32, 2, 4, 16, True),
    (2, 64, 64, 2, 2, 32, True),
    (1, 32, 32, 4, 1, 64, False),
    (2, 48, 48, 2, 3, 16, True),
    (1, 100, 100, 1, 2, 128, True),
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
    with pytest.raises(NotImplementedError):
        ops.flash_attention(x, x, x, k_scale=torch.ones(1, 4, 2, device=cuda),
                            v_scale=torch.ones(1, 4, 2, device=cuda))
    with pytest.raises(ValueError):
        ops.flash_attention(x[:, :, :, :4].contiguous(), x, x)


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
