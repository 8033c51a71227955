"""Flash-decode attention on Hopper: wrapper and plain version.

``kernel`` launches ``csrc/decode_attention.cu`` (the port of the TPU
kernel ``repro/kernels/decode_attention.py:decode_attention_pallas``) on
CUDA tensors and raises on anything it does not take; ``plain`` is the
same function in PyTorch (``ref.naive_decode_attention``).  The kernel
reads the cache in its model layout ``(B, S, Hkv, D)`` through strides —
no transpose, no padding of S — and splits the sequence across CTAs
(:func:`plan_split`), merging the partials by log-sum-exp.  On request
it also returns each row's log-sum-exp (``return_lse``): the sequence
placement policies run it over each rank's window and merge by it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import LaunchCounter, heads, ref

REPLACES = "src/repro/kernels/decode_attention.py:92"
SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
COUNTER = LaunchCounter("decode_attention")
MAX_G = 8
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_MAX = 256          # positions per CTA at most
SPLIT_MIN = 64           # and at least, whatever the grid
H100_SMS = 132


def plan_split(S: int, rows: int, sms: int = H100_SMS) -> tuple[int, int]:
    """``(split, n_split)``: CTA ``z`` of each of the ``rows`` = B * Hkv
    (batch row, KV head) pairs takes positions ``[z * split, (z + 1) *
    split)`` of a cache of ``S`` positions.  From the shapes alone, with
    no look at the lengths (no host sync): ``SPLIT_MAX`` positions,
    halved while the grid would hold fewer than two CTAs per SM, down to
    ``SPLIT_MIN``.  The serve shape (16 slots x 8 KV heads, S 1024) gets
    256 positions in 4 spans: 512 CTAs.  An empty cache gets one span."""
    split = SPLIT_MAX
    while split > SPLIT_MIN and rows * -(-S // split) < 2 * sms:
        split //= 2
    return split, max(1, -(-S // split))


def plain(q, k_cache, v_cache, lengths, *, scale: float | None = None,
          return_lse: bool = False):
    return ref.naive_decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                      return_lse=return_lse)


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i64, i64, i64, i64,
                       ctypes.c_float, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_operand(name: str, x: torch.Tensor, D: int, vec: int) -> None:
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"{name}: heads and head_dim must be contiguous, got "
                         f"strides {x.stride()}")
    if x.data_ptr() % 16 or x.stride(0) % vec or x.stride(1) % vec:
        raise ValueError(f"{name}: needs 16-byte aligned rows for vector loads")


def kernel(q, k_cache, v_cache, lengths, *, scale: float | None = None,
           return_lse: bool = False):
    """q (B, Hq, D), k/v (B, S, Hkv, D), lengths (B,) -> (B, Hq, D) on the
    GPU, in q's dtype, and with ``return_lse`` lse (B, Hkv, G) f32, the
    natural log-sum-exp of each row's scaled scores (a row with no
    position gives out 0 and lse <= -1e30).  Positions at or past
    ``min(lengths[b], S)`` are masked.  q and the cache may differ in dtype (f32 activations over a
    bf16 cache).  bf16 queries over a bf16 cache run on the tensor cores;
    the other pairs (float32 mode) on f32 FMA.

    When :func:`plan_split` cuts the sequence into more than one span
    (the serve shape does), this is two launches on the stream: the split
    kernel, which writes f32 partials to a workspace allocated here, and
    a small kernel that merges them.  The launch counter counts the call
    once."""
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda and lengths.is_cuda):
        raise ValueError("decode_attention kernel needs CUDA tensors")
    if (q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES
            or v_cache.dtype != k_cache.dtype):
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; q and the cache each f32 or bf16, "
                        "k and v alike")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or Hq % Hkv or lengths.shape != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}, lengths {tuple(lengths.shape)}")
    G = Hq // Hkv
    vec = 16 // k_cache.element_size()
    if G > MAX_G or D > MAX_D or D % vec:
        raise ValueError(f"decode_attention kernel takes G <= {MAX_G}, D <= {MAX_D}, "
                         f"D % {vec} == 0; got G={G} D={D}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    _check_operand("k_cache", k_cache, D, vec)
    _check_operand("v_cache", v_cache, D, vec)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hkv, G, dtype=torch.float32, device=q.device)
           if return_lse else None)
    split, n_split = plan_split(S, B * Hkv, sm_count(q.device))
    ws = (torch.empty(B * Hkv * n_split * G * (D + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 B, S, Hkv, G, D, k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
                 v_cache.stride(1), scale, split, n_split, _DTYPES[q.dtype],
                 _DTYPES[k_cache.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    COUNTER.count("lse" if return_lse else "unscaled", heads(Hkv, G, D))
    return (out, lse) if return_lse else out
