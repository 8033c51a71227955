"""Model-layout entry points to the attention kernels.

Counterpart of ``repro.kernels.ops``.  A CUDA tensor goes to the Hopper
kernel (or the wrapper raises); a CPU tensor goes to the kernel's plain
PyTorch version and never touches the kernel library.  Each kernel
counts its launches (:func:`launch_counts`), by variant too
(:func:`variant_counts`: "unscaled", or the fp8/int8 scaled ones) and by
head shape (:func:`shape_counts`).  A captured CUDA graph's replay makes no
Python call: the program that replays it adds the launches its capture
made (:func:`snapshot_counts`, :func:`counts_since`, :func:`add_counts`).
:class:`FlashAttentionFn` is causal self-attention with a gradient on
CUDA tensors: the flash kernel forward with its log-sum-exp (counted as
the prefill kernel's ``"lse"`` variant), the flash backward kernel
(``kernels/flash_attention_bwd.py``, counted under
``"flash_attention_bwd"``) as its backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LaunchCounter
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import prefill_attention as _prefill

KERNELS = {"decode_attention": _decode, "prefill_attention": _prefill,
           "paged_decode_attention": _paged, "flash_attention_bwd": _bwd}


def launch_counts() -> dict[str, int]:
    return {name: mod.COUNTER.launches for name, mod in KERNELS.items()}


def variant_counts() -> dict[str, dict[str, int]]:
    return {name: dict(mod.COUNTER.variants) for name, mod in KERNELS.items()}


def shape_counts() -> dict[str, dict[tuple[str, str], int]]:
    """Launches by (variant, head shape) per kernel: see ``kernels.heads``."""
    return {name: dict(mod.COUNTER.shapes) for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.COUNTER.reset()


def snapshot_counts() -> dict[str, LaunchCounter]:
    """Copies of every kernel's counter, for :func:`counts_since` and
    :func:`restore_counts` around a CUDA graph capture."""
    return {name: mod.COUNTER.copy() for name, mod in KERNELS.items()}


def counts_since(snap: dict[str, LaunchCounter]) -> dict[str, LaunchCounter]:
    """What every counter gained since ``snap``: the launches a captured
    graph makes on each replay."""
    return {name: mod.COUNTER.minus(snap[name]) for name, mod in KERNELS.items()}


def restore_counts(snap: dict[str, LaunchCounter]) -> None:
    """Set every counter back to ``snap`` (a capture launches nothing)."""
    for name, mod in KERNELS.items():
        mod.COUNTER.set_to(snap[name])


def add_counts(delta: dict[str, LaunchCounter]) -> None:
    """Count one replay of a graph whose launches are ``delta`` (a replay
    makes no Python call, so no wrapper counts it)."""
    for name, mod in KERNELS.items():
        mod.COUNTER.add(delta[name])


def _on_cpu(x: torch.Tensor, op: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"{op}: no kernel or plain path for device {x.device}")


def _pair(op: str, k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{op}: give both k_scale and v_scale or neither")


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D) — model layout
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,)
    scale: float | None = None,
    return_lse: bool = False,
):
    """``return_lse`` also returns the per-row log-sum-exp (B, Hkv, G) f32
    (counted as the kernel's ``"lse"`` variant)."""
    fn = _decode.plain if _on_cpu(q, "decode_attention") else _decode.kernel
    return fn(q, k_cache, v_cache, lengths, scale=scale, return_lse=return_lse)


def paged_decode_attention(
    q: torch.Tensor,             # (B, Hq, D) — model layout
    k_pool: torch.Tensor,        # (N, Hkv, block_size, D) — kernel-native
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    lengths: torch.Tensor,       # (B,)
    *,
    scale: float | None = None,
    starts: torch.Tensor | None = None,
    return_lse: bool = False,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
):
    """``starts`` restricts attention to the window ``[start, length)``;
    ``return_lse`` also returns the per-row log-sum-exp (B, Hkv, G) f32.
    ``k_scale``/``v_scale`` (N, Hkv, block_size) f32 mark the pools as
    fp8-e4m3/int8 payloads, dequantized per stored vector."""
    _pair("paged_decode_attention", k_scale, v_scale)
    fn = _paged.plain if _on_cpu(q, "paged_decode_attention") else _paged.kernel
    return fn(q, k_pool, v_pool, block_tables, lengths, scale=scale, starts=starts,
              return_lse=return_lse, k_scale=k_scale, v_scale=v_scale)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D) — model layout
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    scale: float | None = None,
    causal: bool = True,
    q_offset: int | torch.Tensor = 0,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``q_offset`` is the absolute position of q[:, 0]: a host int, or a
    ``(1,)`` int32 tensor on q's device, passed through to the kernel.
    ``k_scale``/``v_scale`` (B, Sk, Hkv) f32 mark k/v as int8/fp8
    payloads, dequantized per stored vector."""
    _pair("flash_attention", k_scale, v_scale)
    fn = _prefill.plain if _on_cpu(q, "flash_attention") else _prefill.kernel
    return fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset, k_scale=k_scale,
              v_scale=v_scale)


class FlashAttentionFn(torch.autograd.Function):
    """Causal self-attention (``Sq == Sk``, ``q_offset`` 0) with a gradient
    on CUDA tensors: ``FlashAttentionFn.apply(q, k, v, scale)``, q (B, S,
    Hq, D), k and v (B, S, Hkv, D).  The forward launches the flash kernel
    with its log-sum-exp and saves q, k, v, the output and the lse; the
    backward launches the flash backward kernel on them.  Either kernel
    raises if it cannot build or launch (on CPU tensors too); nothing
    gives way to a plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _bwd.check(q, k, v)
        out, lse = _prefill.kernel(q, k, v, causal=True, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_bwd.kernel(q, k, v, out, do.contiguous(), lse, scale=ctx.scale), None)

