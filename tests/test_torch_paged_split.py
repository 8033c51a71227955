"""The split paged decode kernel's algebra, on the CPU.

``csrc/paged_decode_attention.cu`` cuts each (batch row, KV head) into
spans of ``split`` positions (``paged_decode_attention.plan``), keeps of
span ``z`` the positions ``[max(z * split, starts[b]), min((z + 1) *
split, MB * bs, lengths[b]))``, cuts that window into 64-position warp
slabs from its first live position (slab ``i`` to warp ``i % 4``), and
merges the partial softmax states by log-sum-exp: slabs within a warp,
warps within a span, spans within a row.  Here the same cuts run through
the plain oracle ``ref.paged_decode_attention(starts=..., lengths=...,
return_lse=True)``, merged with ``ref.lse_merge``; the result must equal
the unsplit oracle, the JAX package's ``repro.kernels.ref.
paged_decode_attention`` and, at the small cases, the interpret-mode
Pallas kernel (through ``repro.kernels.ops``).  The scaled pools run the
kernel's own algebra — score ``(q . payload) * k_scale``, ``p * v_scale``
before P V — against the dequantize-first oracles.

Tolerance: f32 2e-6 on outputs, as ``tests/test_kernels.py`` holds f32
kernels (the merge only reorders the sums); 1e-5 on the lse, a log of
sums of up to 1024 terms whose size is a few units.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.kernels import ref

TOL = 2e-6
LSE_TOL = 1e-5
SLAB, WARPS = 64, 4
SERVE_LENGTHS = [1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700, 900, 1000,
                 1023]
PAGED_CASES = [
    # (B, Hkv, G, D, block_size, max_blocks, lengths) — tests/test_paged.py's
    # cases and tests/test_torch_cuda_kernels.py's
    (1, 1, 1, 8, 8, 2, (5,)),
    (3, 2, 4, 16, 8, 4, (5, 17, 32)),
    (2, 2, 8, 32, 16, 3, (1, 48)),
    (2, 1, 3, 16, 8, 4, (9, 25)),
    (3, 2, 4, 128, 4, 9, (0, 33, 36)),
]
# tests/test_paged.py's shapes run the interpret-mode Pallas kernel too
PALLAS_CASES = PAGED_CASES[:4]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads; one thread
    keeps this module from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Hkv, G, D, bs, MB, lengths, seed):
    """Scrambled tables (null block 0 past each row's live blocks),
    garbage in block 0, numpy f32 from a seed."""
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    q = rng.standard_normal((B, Hkv * G, D), np.float32)
    kp = rng.standard_normal((N, Hkv, bs, D), np.float32)
    vp = rng.standard_normal((N, Hkv, bs, D), np.float32)
    kp[0], vp[0] = 99.0, -99.0
    perm = iter(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        for j in range(min(-(-int(lengths[b]) // bs), MB)):
            tables[b, j] = next(perm)
    return q, kp, vp, tables


def _merge(parts):
    """Merged (out, lse) of partial states over disjoint windows."""
    return ref.lse_merge(parts), torch.logsumexp(torch.stack([lse for _, lse in parts]), dim=0)


def _split(window, lengths, starts, MB, bs, split, n_split):
    """``window(lo, end)`` -> (out, lse) over positions [lo, end) per row,
    cut and merged as the kernel does."""
    cap = MB * bs
    spans = []
    for z in range(n_split):
        lo = torch.clamp(starts, min=z * split)
        end = torch.clamp(lengths, max=min((z + 1) * split, cap))
        warps = [[] for _ in range(WARPS)]
        for i in range(-(-split // SLAB)):
            a = lo + i * SLAB
            warps[i % WARPS].append(window(a, torch.minimum(a + SLAB, end)))
        spans.append(_merge([_merge(w) for w in warps if w]))
    return _merge(spans)


def _lengths_cases(bs, MB, split):
    """Serve, random and edge lengths for a table of MB blocks of bs."""
    cap = MB * bs
    rng = np.random.default_rng(cap + bs)
    edges = [0, 1, bs - 1, bs, bs + 1, split - 1, split, split + 1, cap - 1, cap, cap + 5,
             2 * split + bs + 1, 0, 3, cap + 1000, 17]
    return {"serve": SERVE_LENGTHS,
            "random": rng.integers(0, cap + 40, size=16).tolist(),
            "edges": edges}


def _starts_cases(lengths, bs, split):
    """starts at 0, inside a span, at a span edge, at a block edge, and
    past the length."""
    n = torch.as_tensor(lengths, dtype=torch.int32)
    return {"zero": torch.zeros_like(n),
            "inside": (n // 3).to(torch.int32),
            "span edge": torch.where(n > split, torch.full_like(n, split), n // 2),
            "block edge": (n // 2 // bs * bs).to(torch.int32),
            "past len": n + 3}


def _paged_window(q, kp, vp, tables):
    """The plain oracle over [lo, end) per row, with its lse."""
    def window(lo, end):
        return ref.paged_decode_attention(q, kp, vp, tables, end, starts=lo, return_lse=True)
    return window


@pytest.mark.parametrize("starts_kind", ["zero", "inside", "span edge", "block edge",
                                         "past len"])
@pytest.mark.parametrize("lengths_kind", ["serve", "random", "edges"])
def test_paged_split_merge_equals_unsplit(lengths_kind, starts_kind):
    """llama3.2-1b's table (64 blocks of 16) over 16 rows at two KV heads,
    cut by the wrapper's plan for the serve grid (16 x 8 rows: 4 spans of
    256) and by the plan for these 32 rows, against the
    unsplit oracle and JAX's: outputs, lse, and exact zeros for empty
    windows.  The plan for these 32 rows is 16 spans of 64."""
    B, Hkv, G, D, bs, MB = 16, 2, 4, 32, 16, 64
    serve_plan = kpaged.plan(MB, bs, 16, 8)
    assert serve_plan == (256, 4)
    lengths = _lengths_cases(bs, MB, serve_plan[0])[lengths_kind]
    qn, kn, vn, tn = _inputs(B, Hkv, G, D, bs, MB, lengths, seed=len(lengths_kind))
    q, kp, vp, tables = (torch.from_numpy(x) for x in (qn, kn, vn, tn))
    lens = torch.tensor(lengths, dtype=torch.int32)
    starts = _starts_cases(lengths, bs, serve_plan[0])[starts_kind]
    exp, exp_lse = ref.paged_decode_attention(q, kp, vp, tables, lens, starts=starts,
                                              return_lse=True)
    jexp, jlse = jref.paged_decode_attention(*(jnp.asarray(x) for x in (qn, kn, vn, tn)),
                                             jnp.asarray(lens.numpy()),
                                             starts=jnp.asarray(starts.numpy()),
                                             return_lse=True)
    live = (torch.clamp(lens, max=MB * bs) > starts).numpy()
    assert kpaged.plan(MB, bs, B, Hkv) == (64, 16)
    for split, n_split in (serve_plan, kpaged.plan(MB, bs, B, Hkv)):
        assert split * n_split >= MB * bs
        got, lse = _split(_paged_window(q, kp, vp, tables), lens, starts, MB, bs, split,
                          n_split)
        for theirs in (exp, jexp):
            np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)
        for theirs in (exp_lse, jlse):
            np.testing.assert_allclose(lse.numpy()[live], np.asarray(theirs)[live],
                                       atol=LSE_TOL, rtol=LSE_TOL)
        assert np.all(got.numpy()[~live] == 0.0) and np.all(lse.numpy()[~live] <= -1e30)


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: f"G{c[2]}-D{c[3]}-bs{c[4]}")
def test_paged_split_merge_small_cases(case):
    """The kernel tests' shapes, plain and with a ``starts`` window (one
    row's window empty): the planned cut (one span here) and a forced cut
    into spans of 8 and 16 positions (several slabs and spans per row)
    against the unsplit oracle, JAX's and, at tests/test_paged.py's
    shapes, the interpret-mode Pallas kernel."""
    B, Hkv, G, D, bs, MB, lengths = case
    qn, kn, vn, tn = _inputs(B, Hkv, G, D, bs, MB, lengths, seed=B * D)
    q, kp, vp, tables = (torch.from_numpy(x) for x in (qn, kn, vn, tn))
    lens = torch.tensor(lengths, dtype=torch.int32)
    jargs = [jnp.asarray(x) for x in (qn, kn, vn, tn, lens.numpy())]
    for starts in (torch.zeros_like(lens), (lens // 3).to(torch.int32)):
        if int(starts.sum()):
            starts[0] = lens[0] + 2
        exp = ref.paged_decode_attention(q, kp, vp, tables, lens, starts=starts)
        theirs = [exp, jref.paged_decode_attention(*jargs, starts=jnp.asarray(starts.numpy()))]
        if case in PALLAS_CASES:
            theirs.append(jops.paged_decode_attention(*jargs,
                                                      starts=jnp.asarray(starts.numpy())))
        plans = [kpaged.plan(MB, bs, B, Hkv)] + [(s, -(-MB * bs // s)) for s in (8, 16)]
        for split, n_split in plans:
            got, _ = _split(_paged_window(q, kp, vp, tables), lens, starts, MB, bs, split,
                            n_split)
            for t in theirs:
                np.testing.assert_allclose(got.numpy(), np.asarray(t), atol=TOL, rtol=TOL)


# ---- scaled pools: the kernel's algebra against dequantize-first ---------
def _scaled_window(q, kp, vp, ks, vs, tables, scale=None):
    """The kernel's algebra over [lo, end) per row: score = (q . payload)
    * k_scale * scale, p = exp(score - m), P V over p * v_scale and the
    payload, divided by the sum of the unscaled p."""
    B, Hq, D = q.shape
    k = ref.gather_paged_cache(kp, tables).float()               # (B, S, Hkv, D)
    v = ref.gather_paged_cache(vp, tables).float()
    ksc = ref.gather_paged_scales(ks, tables).permute(0, 2, 1)    # (B, Hkv, S)
    vsc = ref.gather_paged_scales(vs, tables).permute(0, 2, 1)
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, D)
    raw = torch.einsum("bhgd,bkhd->bhgk", qf, k)
    pos = torch.arange(S)

    def window(lo, end):
        valid = ((pos[None] >= lo[:, None]) & (pos[None] < end[:, None]))[:, None, None]
        s = torch.where(valid, raw * ksc[:, :, None] * scale, torch.full_like(raw, ref.NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgk,bkhd->bhgd", p * vsc[:, :, None], v) / l.clamp_min(1e-30)
        return o.reshape(B, Hq, D), (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return window


def _to_jax(x: torch.Tensor):
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(x.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("kv", ["fp8", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES[1:] + [
    (16, 2, 4, 64, 16, 64, tuple(SERVE_LENGTHS))], ids=lambda c: f"B{c[0]}-D{c[3]}-bs{c[4]}")
def test_scaled_split_algebra_matches_dequantize_first(case, kv):
    """fp8/int8 pools quantized from unit-normal data (garbage scales in
    null block 0): the kernel's scaled algebra, split as planned and into
    16-position spans, with and without a ``starts`` window, against the
    dequantize-first oracles (the port's and JAX's).  Unit-normal data
    keeps the scores small enough for f32 2e-6: over 3x that data the two
    f32 orders of the product differ by up to ~6e-6, as the port's and
    JAX's dequantize-first oracles do from each other."""
    B, Hkv, G, D, bs, MB, lengths = case
    qn, kn, vn, tn = _inputs(B, Hkv, G, D, bs, MB, lengths, seed=D + len(kv))
    q, tables = torch.from_numpy(qn), torch.from_numpy(tn)
    (kq, ks), (vq, vs) = (ref.kv_quantize(torch.from_numpy(x), kv) for x in (kn, vn))
    ks[0], vs[0] = 7.5, -3.0
    lens = torch.tensor(lengths, dtype=torch.int32)
    window = _scaled_window(q, kq, vq, ks, vs, tables)
    for starts in (torch.zeros_like(lens), (lens // 3).to(torch.int32)):
        exp, exp_lse = ref.paged_decode_attention(q, kq, vq, tables, lens, starts=starts,
                                                  return_lse=True, k_scale=ks, v_scale=vs)
        jexp = jref.paged_decode_attention(
            jnp.asarray(qn), _to_jax(kq), _to_jax(vq), jnp.asarray(tn),
            jnp.asarray(lens.numpy()), starts=jnp.asarray(starts.numpy()),
            k_scale=_to_jax(ks), v_scale=_to_jax(vs))
        live = (torch.clamp(lens, max=MB * bs) > starts).numpy()
        for split, n_split in (kpaged.plan(MB, bs, B, Hkv), (16, -(-MB * bs // 16))):
            got, lse = _split(window, lens, starts, MB, bs, split, n_split)
            for theirs in (exp, jexp):
                np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=TOL,
                                           rtol=TOL)
            np.testing.assert_allclose(lse.numpy()[live], exp_lse.numpy()[live],
                                       atol=LSE_TOL, rtol=LSE_TOL)


def test_one_byte_payloads_are_exact_in_bf16():
    """Every int8 value and every finite e4m3 value survives the widening
    to a bf16 tile: payload -> f32 -> bf16 -> f32 is the identity."""
    i8 = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    e4m3 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn)
    for x in (i8, e4m3):
        f = x.float()
        f = f[torch.isfinite(f)]
        assert f.numel() == (256 if x.dtype == torch.int8 else 254)    # e4m3fn: 2 NaNs
        assert torch.equal(f.bfloat16().float(), f)


@pytest.mark.parametrize("MB,bs,B,Hkv,want", [
    # llama3.2-1b serve, 16 slots: the hot launch's device tables and the
    # cold launch's host tables (the same shape)
    (64, 16, 16, 8, (256, 4)),
    (64, 16, 8, 8, (128, 8)),     # 8 slots: spans halve to keep 2 CTAs per SM
    (64, 16, 4, 8, (64, 16)),     # 4 slots: never below 64 positions
    (8, 8, 2, 8, (64, 1)),        # chip_smoke's reduced pool: one span, no merge kernel
    (2, 8, 1, 1, (64, 1)),
    (9, 4, 3, 2, (64, 1)),
])
def test_paged_plan(MB, bs, B, Hkv, want):
    assert kpaged.plan(MB, bs, B, Hkv) == want
    assert kpaged.plan(MB, bs, B, Hkv) == kdec.plan_split(MB * bs, B * Hkv)
