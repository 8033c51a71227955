"""The port's attention kernels and their plain versions against the JAX
package: kernel-level oracles (``ref``), the interpret-mode Pallas
kernels (``ops``) and the model-level plain paths (``models.attention``),
on the cases of ``tests/test_kernels.py``.  Inputs come from numpy seeds
and go to both frameworks.

Tolerances: f32 1e-5 (the two frameworks sum in different orders); bf16
2e-2 (as ``tests/test_kernels.py``).  The Hopper kernels themselves are
held against these plain versions in ``tests/test_torch_cuda_kernels.py``.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

DECODE_CASES = [
    # (B, S, Hkv, G, D, block_s)
    (1, 16, 1, 1, 8, 8),
    (2, 64, 2, 4, 32, 16),
    (3, 128, 4, 8, 64, 32),
    (2, 96, 2, 7, 16, 32),
    (1, 33, 1, 2, 128, 16),
]
PREFILL_CASES = [
    # (B, Sq, Sk, Hkv, G, D, bq, bk, causal)
    (1, 16, 16, 1, 1, 8, 8, 8, True),
    (2, 32, 32, 2, 4, 16, 16, 16, True),
    (2, 64, 64, 2, 2, 32, 16, 32, True),
    (1, 32, 32, 4, 1, 64, 16, 16, False),
    (2, 48, 48, 2, 3, 16, 16, 16, True),
]


def _both(x: np.ndarray, dtype: str):
    """One numpy array -> (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


def _decode_inputs(case, seed=0):
    B, S, Hkv, G, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * G, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    return q, k, v, lengths


def _prefill_inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32))


# --------------------------------------------------------------- decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax(case, dtype):
    q, k, v, lengths = _decode_inputs(case)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    tl = torch.from_numpy(lengths)
    tol = TOL[dtype]
    out = ref.naive_decode_attention(tq, tk, tv, tl)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(
        _np(out), _np(jref.naive_decode_attention(jq, jk, jv, jnp.asarray(lengths))),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(out), _np(jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                            block_s=case[-1])),
        atol=tol, rtol=tol)
    # ops on CPU tensors is the plain version itself
    np.testing.assert_array_equal(_np(ops.decode_attention(tq, tk, tv, tl)), _np(out))
    # the model-level plain path mirrors the reference engine's casts
    np.testing.assert_allclose(
        _np(attn.decode_attention(tq, tk, tv, tl)),
        _np(jattn.decode_attention(jq, jk, jv, jnp.asarray(lengths))),
        atol=tol, rtol=tol)


def test_decode_plain_respects_lengths():
    """Positions at or past ``lengths`` must not influence the output."""
    q, k, v, _ = _decode_inputs((2, 32, 2, 2, 16, 8), seed=1)
    lengths = torch.tensor([10, 20], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out1 = ops.decode_attention(tq, tk, tv, lengths)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[0, 10:], tk2[1, 20:] = 99.0, -99.0
    tv2[0, 10:], tv2[1, 20:] = 7.0, -7.0
    np.testing.assert_allclose(_np(ops.decode_attention(tq, tk2, tv2, lengths)),
                               _np(out1), atol=1e-6)
    np.testing.assert_allclose(_np(attn.decode_attention(tq, tk2, tv2, lengths)),
                               _np(attn.decode_attention(tq, tk, tv, lengths)),
                               atol=1e-6)


# -------------------------------------------------------------- prefill
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_plain_matches_jax(case, dtype):
    B, Sq, Sk, Hkv, G, D, bq, bk, causal = case
    arrays = _prefill_inputs(B, Sq, Sk, Hkv * G, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    tol = TOL[dtype]
    out = ref.naive_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(jref.naive_attention(jq, jk, jv, causal=causal)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(out), _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                           block_q=bq, block_k=bk)),
        atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(ops.flash_attention(tq, tk, tv, causal=causal)),
                                  _np(out))
    np.testing.assert_allclose(
        _np(attn.chunked_attention(tq, tk, tv, causal=causal, chunk=16)),
        _np(jattn.chunked_attention(jq, jk, jv, causal=causal, chunk=16)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("off", [0, 5, 17, 32])
def test_prefill_q_offset_matches_jax(off):
    """Chunked-prefill continuation: a 16-row query block at absolute
    position ``off`` against a 48-position window."""
    B, Sq, Sk, Hkv, G, D = 2, 16, 48, 2, 2, 16
    arrays = _prefill_inputs(B, Sq, Sk, Hkv * G, Hkv, D, seed=off)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in arrays)
    out = ops.flash_attention(tq, tk, tv, causal=True, q_offset=off)
    np.testing.assert_allclose(
        _np(out), _np(jref.naive_attention(jq, jk, jv, causal=True, q_offset=off)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(out), _np(jops.flash_attention(jq, jk, jv, causal=True, q_offset=off,
                                           block_q=8, block_k=16)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(attn.chunked_attention(tq, tk, tv, q_offset=off, chunk=16)),
        _np(jattn.chunked_attention(jq, jk, jv, q_offset=off, chunk=16)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_flash_attention_scaled_variant_matches_reference(kv):
    """The scaled flash plain version (int8/fp8 K/V with (B, Sk, Hkv) f32
    scales) against ``ref.naive_attention(k_scale=..., v_scale=...)``, at
    a chunked-prefill offset; scales must come in pairs."""
    B, Sq, Sk, Hkv, G, D = 2, 8, 24, 2, 2, 16
    q, k, v = _prefill_inputs(B, Sq, Sk, Hkv * G, Hkv, D, seed=4)
    jk, jks = jref.kv_quantize(jnp.asarray(k * 3), kv)
    jv, jvs = jref.kv_quantize(jnp.asarray(v * 3), kv)
    tk, tv = (torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
              if kv == "fp8" else torch.from_numpy(np.array(a)) for a in (jk, jv))
    tks, tvs = torch.from_numpy(np.array(jks)), torch.from_numpy(np.array(jvs))
    out = ops.flash_attention(torch.from_numpy(q), tk, tv, q_offset=16, k_scale=tks,
                              v_scale=tvs)
    exp = jref.naive_attention(jnp.asarray(q), jk, jv, q_offset=16, k_scale=jks,
                               v_scale=jvs)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="both"):
        ops.flash_attention(torch.from_numpy(q), tk, tv, k_scale=tks)


def test_ops_on_cpu_never_touch_the_kernel_library():
    """CPU tensors take the plain path: no kernel is built, loaded or
    counted, and ``_build`` is never imported."""
    code = (
        "import sys, torch\n"
        "from repro_torch.kernels import ops\n"
        "from repro_torch.core import offload\n"
        "q = torch.randn(2, 4, 16); k = torch.randn(2, 8, 2, 16)\n"
        "ops.decode_attention(q, k, k, torch.tensor([3, 8]))\n"
        "offload.decode_attention(q, k, k, torch.tensor([3, 8]))\n"
        "x = torch.randn(1, 5, 4, 16); y = torch.randn(1, 5, 2, 16)\n"
        "ops.flash_attention(x, y, y); offload.prefill_attention(x, y, y)\n"
        "pool = torch.randn(5, 2, 4, 16); t = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)\n"
        "ops.paged_decode_attention(q, pool, pool, t, torch.tensor([6, 3]))\n"
        "offload.paged_decode_attention(q, pool, pool, t, torch.tensor([6, 3]))\n"
        "assert 'repro_torch.kernels._build' not in sys.modules\n"
        "assert ops.launch_counts() == {'decode_attention': 0, 'prefill_attention': 0,\n"
        "                               'paged_decode_attention': 0,\n"
        "                               'flash_attention_bwd': 0}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
