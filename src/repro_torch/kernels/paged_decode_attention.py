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
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import SCALED, LaunchCounter, ref, variant

REPLACES = "src/repro/kernels/paged_decode_attention.py:119"
SOURCE = "src/repro_torch/kernels/csrc/paged_decode_attention.cu"
COUNTER = LaunchCounter("paged_decode_attention")
MAX_G = 8
MAX_D = 128
MAX_BLOCK = 64
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_Q_DTYPES, torch.float8_e4m3fn: 2, torch.int8: 3}


def plain(q, k_pool, v_pool, block_tables, lengths, *, scale: float | None = None,
          starts=None, return_lse: bool = False, k_scale=None, v_scale=None):
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                      scale=scale, starts=starts, return_lse=return_lse,
                                      k_scale=k_scale, v_scale=v_scale)



def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, i, i, p]
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
        if s.shape != k_pool.shape[:3] or not s.is_contiguous() or not s.is_cuda:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous CUDA "
                             f"tensor of shape {tuple(k_pool.shape[:3])}, got "
                             f"{tuple(s.shape)}")


def kernel(q, k_pool, v_pool, block_tables, lengths, *, scale: float | None = None,
           starts=None, return_lse: bool = False, k_scale=None, v_scale=None):
    """q (B, Hq, D), pools (N, Hkv, bs, D), block_tables (B, MB) int32,
    lengths (B,) -> out (B, Hq, D) in q's dtype, and lse (B, Hkv, G) f32
    when ``return_lse``.  Position ``p`` of row ``b`` is attended iff
    ``starts[b] <= p < min(lengths[b], MB * bs)``.  An fp8-e4m3 or int8
    pool needs ``k_scale``/``v_scale`` (N, Hkv, bs) f32, and only such a
    pool takes them.  Table entries must lie in ``[0, N)`` (the engine's
    tables always do; the kernel does not check them)."""
    tensors = (q, k_pool, v_pool, block_tables, lengths) + (
        () if starts is None else (starts,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention kernel needs CUDA tensors")
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
    if G > MAX_G or D > MAX_D or D % vec or bs > MAX_BLOCK:
        raise ValueError(f"paged_decode_attention kernel takes G <= {MAX_G}, "
                         f"D <= {MAX_D}, D % {vec} == 0, block_size <= {MAX_BLOCK}; "
                         f"got G={G} D={D} block_size={bs}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools need 16-byte alignment")
    _check_scales(k_pool, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lengths = _int32_vector("lengths", lengths, B)
    starts = None if starts is None else _int32_vector("starts", starts, B)
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hkv, G, dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 None if starts is None else starts.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, MB, Hkv, bs, G, D, scale,
                 _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    COUNTER.count(variant(k_pool.dtype))
    return (out, lse) if return_lse else out
