"""Causal flash attention (prefill) on Hopper: wrapper and plain version.

``kernel`` launches ``csrc/prefill_attention.cu`` (the port of the TPU
kernel ``repro/kernels/prefill_attention.py:flash_attention_pallas``) on
CUDA tensors in the model layout; ``plain`` is the same function in
PyTorch (``ref.naive_attention``).  Any Sq and Sk work: the kernel masks
the ragged edges itself.  bf16 queries run on the tensor cores (the
query heads of each KV head packed as the rows of one tile); f32 queries
(float32 mode) on f32 FMA.  int8 or fp8-e4m3 K/V come with f32 scales
``k_scale``/``v_scale`` in the model layout ``(B, Sk, Hkv)`` and are
dequantized in the kernel (the TPU kernel's scaled variant; no serving
path of the reference reaches it).  For training, ``return_lse`` also
returns each row's log-sum-exp ``(B, Hq, Sq)`` f32 of the scaled scores
(natural log), which the flash backward (``flash_attention_bwd``) reads;
such a launch is counted as the ``"lse"`` variant.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import SCALED, LaunchCounter, heads, ref, variant

REPLACES = "src/repro/kernels/prefill_attention.py:112"
SOURCE = "src/repro_torch/kernels/csrc/prefill_attention.cu"
COUNTER = LaunchCounter("prefill_attention")
MAX_D = 128
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_Q_DTYPES, torch.float8_e4m3fn: 2, torch.int8: 3}


def plain(q, k, v, *, causal: bool = True, scale: float | None = None,
          q_offset: int | torch.Tensor = 0, k_scale=None, v_scale=None,
          return_lse: bool = False):
    out = ref.naive_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                              k_scale=k_scale, v_scale=v_scale)
    if not return_lse:
        return out
    return out, ref.attention_lse(q, k, causal=causal, scale=scale, q_offset=q_offset,
                                  k_scale=k_scale)


def _check_scales(k, k_scale, v_scale) -> None:
    """Scales exactly for quantized K/V: both f32 CUDA tensors of shape
    ``(B, Sk, Hkv)`` with one set of strides (read as they lie)."""
    quant = k.dtype in SCALED
    if (k_scale is None) != (v_scale is None):
        raise ValueError("prefill_attention: give both k_scale and v_scale or neither")
    if quant != (k_scale is not None):
        raise ValueError(f"prefill_attention: {k.dtype} K/V "
                         f"{'need' if quant else 'take no'} k_scale/v_scale")
    if not quant:
        return
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32:
            raise TypeError(f"prefill_attention: {name} must be float32, got {s.dtype}")
        if s.shape != k.shape[:3] or not s.is_cuda:
            raise ValueError(f"prefill_attention: {name} must be a CUDA tensor of shape "
                             f"{tuple(k.shape[:3])}, got {tuple(s.shape)}")
    if k_scale.stride() != v_scale.stride():
        raise ValueError("prefill_attention: k_scale and v_scale need the same strides")


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("prefill_attention")
    fn = lib.prefill_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, p, p, i, i, i, i, i, i, i, p, i,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _offset(q_offset, device) -> tuple[int, int | None]:
    """``(int, device pointer)`` of the launch: a host int goes in the
    kernel's arguments; a ``(1,)`` int32 tensor on q's device is read by
    the kernel from device memory (a captured graph's launch then serves
    whatever offset the tensor holds at replay)."""
    if not isinstance(q_offset, torch.Tensor):
        return int(q_offset), None
    if q_offset.dtype != torch.int32 or q_offset.numel() != 1 or q_offset.device != device:
        raise ValueError(f"prefill_attention: a tensor q_offset must be one int32 on "
                         f"{device}, got {q_offset.dtype} {tuple(q_offset.shape)} on "
                         f"{q_offset.device}")
    return 0, q_offset.data_ptr()


def kernel(q, k, v, *, causal: bool = True, scale: float | None = None,
           q_offset: int | torch.Tensor = 0, k_scale=None, v_scale=None,
           return_lse: bool = False):
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) on the GPU,
    in q's dtype.  ``q_offset`` is the absolute position of q[:, 0]: a
    host int, or a ``(1,)`` int32 CUDA tensor that the kernel reads from
    device memory (the TPU kernel's scalar prefetch; the grid does not
    depend on it).  q and k/v may differ in dtype (the chunked prefill of
    float32 mode attends f32 queries against the bf16 cache); int8/fp8
    K/V need ``k_scale``/``v_scale`` (B, Sk, Hkv) f32.  ``return_lse``:
    ``(out, lse (B, Hq, Sq) f32)``."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("prefill_attention kernel needs CUDA tensors")
    if q.dtype not in _Q_DTYPES or k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"prefill_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "q f32 or bf16, k/v f32, bf16, fp8-e4m3 or int8, k and v alike")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"prefill_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    vec = max(8, 16 // k.element_size())
    if D > MAX_D or D % vec:
        raise ValueError(f"prefill_attention kernel takes D <= {MAX_D}, D % {vec} == 0; "
                         f"got D={D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"prefill_attention: {name} must be contiguous and "
                             "16-byte aligned")
    _check_scales(k, k_scale, v_scale)
    off, off_ptr = _offset(q_offset, q.device)
    ss = (0, 0, 0) if k_scale is None else k_scale.stride()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(), *ss, out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, D, off, off_ptr, int(causal), scale,
                 _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: CUDA error {err}")
    COUNTER.count("lse" if return_lse else variant(k.dtype), heads(Hkv, Hq // Hkv, D))
    return (out, lse) if return_lse else out
