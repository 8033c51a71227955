"""The split decode kernel's algebra, on the CPU.

``csrc/decode_attention.cu`` cuts each (batch row, KV head) sequence into
spans of ``split`` positions (``decode_attention.plan_split``), each span
into warp slabs of 32 positions, and merges the partial softmax states by
log-sum-exp.  Here the same cuts run through the plain oracles: the
window attention ``ref.naive_decode_attention(starts=..., lengths=...,
return_lse=True)`` over each piece, merged with ``ref.lse_merge``, must
equal the unsplit oracle and the JAX package's
``repro.kernels.ref.naive_decode_attention``, empty spans and rows of
length 0 included.  Tolerance: f32 2e-6, as ``tests/test_kernels.py``
holds f32 kernels (the merge only reorders the sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import ref

TOL = 2e-6
SERVE_LENGTHS = [1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700, 900, 1000,
                 1023]


def _inputs(B, S, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _window(q, k, v, lengths, lo, hi):
    """The oracle over positions [lo, hi) of every row (clamped to its
    length), with its lse."""
    n = torch.as_tensor(lengths).clamp(max=hi)
    starts = torch.full_like(n, lo)
    return ref.naive_decode_attention(q, k, v, n, starts=starts, return_lse=True)


def _split(q, k, v, lengths, split, n_split, slab=None):
    """Attention merged over the spans of ``split`` positions; with
    ``slab``, each span first merged from its slabs (the kernel's warps)."""
    parts = []
    for z in range(n_split):
        lo, hi = z * split, (z + 1) * split
        if slab is None:
            parts.append(_window(q, k, v, lengths, lo, hi))
            continue
        pieces = [_window(q, k, v, lengths, a, min(a + slab, hi)) for a in range(lo, hi, slab)]
        o = ref.lse_merge(pieces)
        lse = torch.logsumexp(torch.stack([p[1] for p in pieces]), dim=0)
        parts.append((o, lse))
    return ref.lse_merge(parts)


def _lengths_cases():
    rng = np.random.default_rng(7)
    return [("serve", SERVE_LENGTHS),
            ("random", rng.integers(0, 1100, size=16).tolist()),
            ("zeros and edges", [0, 0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1023,
                                 1024, 1025, 0])]


@pytest.mark.parametrize("rows", [128, 32, 8])
@pytest.mark.parametrize("name,lengths", _lengths_cases(), ids=lambda x: str(x)[:16])
def test_split_merge_equals_unsplit(name, lengths, rows):
    """The spans the wrapper plans for B * Hkv = ``rows`` at S = 1024 (256,
    128 and 64 positions), merged, against the unsplit oracle and JAX's."""
    B, S, Hkv, G, D = 16, 1024, 2, 4, 32
    split, n_split = kdec.plan_split(S, rows)
    assert n_split * split >= S
    qn, kn, vn = _inputs(B, S, Hkv, G, D, seed=rows)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = _split(q, k, v, lens, split, n_split)
    exp = ref.naive_decode_attention(q, k, v, lens)
    jexp = np.asarray(jref.naive_decode_attention(jnp.asarray(qn), jnp.asarray(kn),
                                                  jnp.asarray(vn),
                                                  jnp.asarray(lens.clamp(max=S).numpy())))
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), jexp, atol=TOL, rtol=TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert float(got[b].abs().max()) == 0.0


def test_split_merge_through_warp_slabs():
    """Two levels, as in the kernel: 32-position slabs merged into a span,
    spans merged into the row; equal to the one-level merge and the
    oracle."""
    B, S, Hkv, G, D = 16, 1024, 1, 8, 16
    split, n_split = kdec.plan_split(S, 128)
    q, k, v = (torch.from_numpy(x) for x in _inputs(B, S, Hkv, G, D, seed=3))
    lens = torch.tensor(SERVE_LENGTHS, dtype=torch.int32)
    two = _split(q, k, v, lens, split, n_split, slab=32)
    one = _split(q, k, v, lens, split, n_split)
    exp = ref.naive_decode_attention(q, k, v, lens)
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(two.numpy(), exp.numpy(), atol=TOL, rtol=TOL)


def test_empty_spans_carry_no_weight():
    """A span past a row's length is empty: output 0 and lse <= -1e30, and
    merging it changes nothing."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 512, 2, 3, 16, seed=4))
    lens = torch.tensor([0, 100], dtype=torch.int32)
    o, lse = _window(q, k, v, lens, 256, 512)
    assert float(o.abs().max()) == 0.0 and float(lse.max()) <= -1e30
    full = _window(q, k, v, lens, 0, 256)
    merged = ref.lse_merge([full, (o, lse)])
    np.testing.assert_allclose(merged.numpy(), full[0].numpy(), atol=TOL, rtol=TOL)
    assert float(merged[0].abs().max()) == 0.0


@pytest.mark.parametrize("S,rows,want", [
    (1024, 128, (256, 4)),        # llama3.2-1b, 16 slots x 8 KV heads
    (1024, 64, (128, 8)),
    (1024, 8, (64, 16)),          # never below 64 positions
    (4096, 128, (256, 16)),
    (16, 1, (64, 1)),
    (0, 128, (64, 1)),            # an empty cache: one (empty) span
])
def test_plan_split(S, rows, want):
    assert kdec.plan_split(S, rows) == want


@pytest.mark.parametrize("S", [1, 33, 255, 256, 257, 1000, 1024, 1033, 8192])
@pytest.mark.parametrize("rows", [1, 8, 64, 128, 512])
def test_plan_split_covers_and_fills(S, rows):
    """The spans cover S with no span wholly past it, the split is one of
    256, 128, 64, and a smaller split is taken only while the grid is
    under two CTAs per SM."""
    split, n_split = kdec.plan_split(S, rows)
    assert split in (64, 128, 256)
    assert n_split == -(-S // split) and (n_split - 1) * split < S <= n_split * split
    if split < kdec.SPLIT_MAX:
        assert rows * -(-S // (2 * split)) < 2 * kdec.H100_SMS
    assert kdec.plan_split(S, rows, sms=0)[0] == kdec.SPLIT_MAX
