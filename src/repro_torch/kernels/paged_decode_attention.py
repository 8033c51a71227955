"""Paged flash-decode attention on Hopper: wrapper and plain version.

``kernel`` launches ``csrc/paged_decode_attention.cu`` (the port of the
TPU kernel ``repro/kernels/paged_decode_attention.py:
paged_decode_attention_pallas``) on CUDA tensors and raises on anything
it does not take; ``plain`` is the same function in PyTorch
(``ref.paged_decode_attention``: gather the blocks into a contiguous
cache, dequantize, then the dense oracle).  The pool is read in its
kernel-native layout ``(N, Hkv, block_size, D)`` through the block
tables, with no gather and no copy; an fp8-e4m3 or int8 pool comes with
its f32 scale pools ``(N, Hkv, block_size)`` and is dequantized in the
kernel.  The kernel splits each row across CTAs (:func:`plan`, the dense
decode's span plan over the positions a table reaches) and merges the
partials by log-sum-exp.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import SCALED, LaunchCounter, heads, ref, variant
from repro_torch.kernels import decode_attention as _decode

REPLACES = "src/repro/kernels/paged_decode_attention.py:119"
SOURCE = "src/repro_torch/kernels/csrc/paged_decode_attention.cu"
COUNTER = LaunchCounter("paged_decode_attention")
MAX_G = 8
MAX_D = 128
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_Q_DTYPES, torch.float8_e4m3fn: 2, torch.int8: 3}


def plain(q, k_pool, v_pool, block_tables, lengths, *, scale: float | None = None,
          starts=None, return_lse: bool = False, k_scale=None, v_scale=None):
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                      scale=scale, starts=starts, return_lse=return_lse,
                                      k_scale=k_scale, v_scale=v_scale)


@functools.cache
def plan(MB: int, bs: int, B: int, Hkv: int, sms: int = _decode.H100_SMS) -> tuple[int, int]:
    """``(split, n_split)`` of a call over ``B`` rows of ``MB`` blocks of
    ``bs`` positions and ``Hkv`` KV heads: CTA ``z`` of each (row, KV
    head) takes positions ``[z * split, (z + 1) * split)`` of the window.
    :func:`decode_attention.plan_split` over the ``MB * bs`` positions the
    table reaches, from the shapes alone (no host sync on ``lengths`` or
    ``starts``); cached per shape.  The serve shape (16 slots x 8 KV heads,
    64 blocks of 16) gets 256 positions in 4 spans: 512 CTAs."""
    return _decode.plan_split(MB * bs, B * Hkv, sms)


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _int32_vector(name: str, x: torch.Tensor, B: int) -> torch.Tensor:
    if x.shape != (B,):
        raise ValueError(f"paged_decode_attention: {name} shape {tuple(x.shape)}, "
                         f"want ({B},)")
    return x.to(torch.int32).contiguous()


def _check_scales(k_pool, k_scale, v_scale) -> None:
    """Scale pools exactly for a quantized pool: both f32, contiguous,
    ``(N, Hkv, bs)``."""
    quant = k_pool.dtype in SCALED
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: give both k_scale and v_scale or neither")
    if quant != (k_scale is not None):
        raise ValueError(f"paged_decode_attention: a {k_pool.dtype} pool "
                         f"{'needs' if quant else 'takes no'} k_scale/v_scale")
    if not quant:
        return
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32:
            raise TypeError(f"paged_decode_attention: {name} must be float32, got {s.dtype}")
        if s.shape != k_pool.shape[:3] or not s.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous "
                             f"tensor of shape {tuple(k_pool.shape[:3])}, got "
                             f"{tuple(s.shape)}")


def check_args(q, k_pool, v_pool, block_tables, k_scale=None, v_scale=None):
    """What :func:`kernel` takes, on any device: dtypes, shapes, layout and
    the scale pools; raises on the rest.  Any block size: each position's
    row is found through the table, so a block larger than a span or a
    warp's slab only means fewer table entries per span.  Returns ``(B,
    Hkv, bs, G, D, MB)``."""
    if (q.dtype not in _Q_DTYPES or k_pool.dtype not in _KV_DTYPES
            or v_pool.dtype != k_pool.dtype):
        raise TypeError(f"paged_decode_attention: dtypes {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}; q f32 or bf16, the pool f32, bf16, fp8-e4m3 "
                        "or int8, k and v alike")
    if block_tables.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: block_tables must be int32, got "
                        f"{block_tables.dtype}")
    if (q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or block_tables.dim() != 2):
        raise ValueError(f"paged_decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, "
                         f"{tuple(block_tables.shape)}")
    B, Hq, D = q.shape
    _, Hkv, bs, Dk = k_pool.shape
    MB = block_tables.shape[1]
    if Dk != D or Hq % Hkv or block_tables.shape[0] != B or MB < 1:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}, tables {tuple(block_tables.shape)}")
    G = Hq // Hkv
    vec = 16 // k_pool.element_size()
    if G > MAX_G or D > MAX_D or D % vec:
        raise ValueError(f"paged_decode_attention kernel takes G <= {MAX_G}, "
                         f"D <= {MAX_D}, D % {vec} == 0; got G={G} D={D}")
    if k_pool.shape[0] * Hkv * bs >= 2**31:
        raise ValueError(f"paged_decode_attention kernel takes pools of under 2^31 vectors; "
                         f"got {k_pool.shape[0]} blocks x {Hkv} heads x {bs}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools need 16-byte alignment")
    _check_scales(k_pool, k_scale, v_scale)
    return B, Hkv, bs, G, D, MB


def kernel(q, k_pool, v_pool, block_tables, lengths, *, scale: float | None = None,
           starts=None, return_lse: bool = False, k_scale=None, v_scale=None):
    """q (B, Hq, D), pools (N, Hkv, bs, D), block_tables (B, MB) int32,
    lengths (B,) -> out (B, Hq, D) in q's dtype, and lse (B, Hkv, G) f32
    when ``return_lse``.  Position ``p`` of row ``b`` is attended iff
    ``starts[b] <= p < min(lengths[b], MB * bs)``.  An fp8-e4m3 or int8
    pool needs ``k_scale``/``v_scale`` (N, Hkv, bs) f32, and only such a
    pool takes them.  Table entries must lie in ``[0, N)`` (the engine's
    tables always do; the kernel does not check them); entries past a
    row's last live block are never read.

    bf16 queries over a bf16, fp8 or int8 pool run on the tensor cores,
    the other pairs (float32 mode) on f32 FMA.  When :func:`plan` cuts
    the rows into more than one span (the serve shape does), this is two
    launches on the stream: the split kernel, which writes f32 partials to
    a workspace allocated here, and a small kernel that merges them (and
    writes the lse).  The launch counter counts the call once."""
    tensors = (q, k_pool, v_pool, block_tables, lengths) + tuple(
        t for t in (starts, k_scale, v_scale) if t is not None)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention kernel needs CUDA tensors")
    B, Hkv, bs, G, D, MB = check_args(q, k_pool, v_pool, block_tables, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lengths = _int32_vector("lengths", lengths, B)
    starts = None if starts is None else _int32_vector("starts", starts, B)
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hkv, G, dtype=torch.float32, device=q.device)
           if return_lse else None)
    split, n_split = plan(MB, bs, B, Hkv, _decode.sm_count(q.device))
    ws = (torch.empty(B * Hkv * n_split * G * (D + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 None if starts is None else starts.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if ws is None else ws.data_ptr(), B, MB, Hkv, bs, G, D, scale,
                 split, n_split, _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    COUNTER.count(variant(k_pool.dtype), heads(Hkv, G, D, bs))
    return (out, lse) if return_lse else out
