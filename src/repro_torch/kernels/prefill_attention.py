"""Causal flash attention (prefill) on Hopper: wrapper and plain version.

``kernel`` launches ``csrc/prefill_attention.cu`` (the port of the TPU
kernel ``repro/kernels/prefill_attention.py:flash_attention_pallas``) on
CUDA tensors in the model layout; ``plain`` is the same function in
PyTorch (``ref.naive_attention``).  Any Sq and Sk work: the kernel masks
the ragged edges itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LaunchCounter, ref

REPLACES = "src/repro/kernels/prefill_attention.py:112"
SOURCE = "src/repro_torch/kernels/csrc/prefill_attention.cu"
COUNTER = LaunchCounter("prefill_attention")
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain(q, k, v, *, causal: bool = True, scale: float | None = None,
          q_offset: int = 0):
    return ref.naive_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("prefill_attention")
    fn = lib.prefill_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def kernel(q, k, v, *, causal: bool = True, scale: float | None = None,
           q_offset: int = 0):
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) on the GPU,
    in q's dtype.  ``q_offset`` (a host int) is the absolute position of
    q[:, 0].  q and k/v may differ in dtype (the chunked prefill of
    float32 mode attends f32 queries against the bf16 cache)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("prefill_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"prefill_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "q and k/v each f32 or bf16, k and v alike")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"prefill_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D > MAX_D or D % 8:
        raise ValueError(f"prefill_attention kernel takes D <= {MAX_D}, D % 8 == 0; "
                         f"got D={D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"prefill_attention: {name} must be contiguous and "
                             "16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, D, int(q_offset), int(causal), scale,
                 _DTYPES[q.dtype], _DTYPES[k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: CUDA error {err}")
    COUNTER.launches += 1
    return out
