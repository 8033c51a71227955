"""Causal flash attention backward on Hopper: wrapper and plain version.

The reference has no Pallas backward: its train step differentiates
``repro/models/attention.py:chunked_attention`` with XLA's autodiff.  The
port's train step runs the forward through the flash kernel
(``prefill_attention.kernel(..., return_lse=True)``), which autograd cannot
pass through, so the gradient is this kernel (``csrc/flash_attention_bwd.cu``),
bound as the backward of ``ops.FlashAttentionFn``.  ``kernel`` launches it
on CUDA tensors in the model layout; ``plain`` computes the same three
gradients with torch ops from the same saved tensors (the CPU's path and
the card's yardstick, never the card's main path).

Shapes: causal, ``Sq == Sk``, ``q_offset`` 0; GQA with G = Hq / Hkv <= 8;
D <= 128 and D % 8 == 0.  bf16 runs on the tensor cores, f32 (float32
mode) on f32 FMA; every sum is f32 and none uses atomics.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LaunchCounter, heads

REPLACES = "src/repro/models/attention.py:29"   # XLA autodiff of chunked_attention
SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
COUNTER = LaunchCounter("flash_attention_bwd")
MAX_D = 128
MAX_G = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain(q, k, v, o, do, lse, *, scale: float | None = None):
    """(dq, dk, dv) of causal attention, from q (B, S, Hq, D), k/v (B, S,
    Hkv, D), the output o and its gradient do (B, S, Hq, D) and the row
    log-sum-exp lse (B, Hq, S) f32; f32 inside, each gradient in its
    input's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    pos = torch.arange(S, device=q.device)
    visible = pos[:, None] >= pos[None, :]
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, S, 1)).masked_fill(~visible, 0.0)
    delta = (dof * o.float().reshape(B, S, Hkv, G, D)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, S, Hq, D) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def check(q, k, v) -> None:
    """Raise unless the kernel takes these shapes: causal self-attention
    (Sq == Sk), G <= 8, D <= 128 and D % 8 == 0, one dtype (bf16 or f32)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Sk != S or Dk != D:
        raise ValueError(f"flash_attention_bwd takes Sq == Sk: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if Hq % Hkv or Hq // Hkv > MAX_G:
        raise ValueError(f"flash_attention_bwd takes G = Hq / Hkv <= {MAX_G}: Hq {Hq}, "
                         f"Hkv {Hkv}")
    if D > MAX_D or D % 8:
        raise ValueError(f"flash_attention_bwd takes D <= {MAX_D}, D % 8 == 0; got D={D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "all bf16 or all f32")


def kernel(q, k, v, o, do, lse, *, scale: float | None = None):
    """(dq, dk, dv) on the GPU, in q's dtype: see :func:`plain`."""
    check(q, k, v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o and do must be like q")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32 {(B, Hq, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if not x.is_cuda or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous, 16-byte "
                             "aligned CUDA tensor")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, S, Hq, Hkv, D, scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    COUNTER.count("unscaled", heads(Hkv, Hq // Hkv, D))
    return dq, dk, dv
