"""Decode and prefill attention routed to the device that holds the data.

Single-device counterpart of ``repro.core.offload`` (``decode_attention``,
``paged_decode_attention``, ``prefill_attention`` and
``mla_decode_attention``).  On the TPU mesh
that module split the KV cache into an "HPU layout"; on one GPU the
cache is already where the attention runs, so what is left is the
choice of implementation: the Hopper kernels for CUDA tensors, the
model-level plain versions (``models/attention.py``, the reference
engine's numerics) for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, D); caches (B, S, Hkv, D); lengths (B,) -> (B, Hq, D).
    The kernel reads K and V in one dtype: a bf16 V beside an f32 K (the
    dequantized ``kv_quant`` cache in float32 mode) is widened, exactly."""
    if q.is_cuda:
        return ops.decode_attention(q, k_cache, v_cache.to(k_cache.dtype), lengths,
                                    scale=scale)
    return attn.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float | None = None, starts: torch.Tensor | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None, return_lse: bool = False):
    """q (B, Hq, D); pools (N, Hkv, bs, D) kernel-native; block_tables
    (B, MB) int32; lengths (B,) -> (B, Hq, D) [, lse (B, Hkv, G)].

    ``starts`` restricts attention to the hot window ``[start, length)``;
    ``k_scale``/``v_scale`` (N, Hkv, bs) f32 mark an fp8/int8 pool;
    ``return_lse`` also returns the log-sum-exp for an lse merge with
    another window's partial.  CPU tensors take the reference engine's
    branch: gather the blocks into a contiguous cache and run the
    model-level decode attention (same numerics as the dense cache); with
    ``starts``, scales or ``return_lse``, the kernel-level oracle."""
    if q.is_cuda:
        return ops.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                          scale=scale, starts=starts,
                                          return_lse=return_lse, k_scale=k_scale,
                                          v_scale=v_scale)
    if starts is None and k_scale is None and not return_lse:
        k = ref.gather_paged_cache(k_pool, block_tables)
        v = ref.gather_paged_cache(v_pool, block_tables)
        return attn.decode_attention(q, k, v, lengths, scale=scale)
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                      scale=scale, starts=starts, return_lse=return_lse,
                                      k_scale=k_scale, v_scale=v_scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int | torch.Tensor = 0, chunk: int = 1024) -> torch.Tensor:
    """Causal prefill (and train) attention; ``q_offset`` places q[:, 0] at
    an absolute position: a host int, or a ``(1,)`` int32 tensor on q's
    device (read by the kernel, or by the plain path, with no host sync).
    CUDA inputs that need a gradient (the train step) go through
    ``ops.FlashAttentionFn``: the flash kernel with its log-sum-exp and
    the flash backward kernel; serving keeps the plain kernel call.  CPU
    inputs take the plain ``chunked_attention``, under autograd when
    training."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            if isinstance(q_offset, torch.Tensor) or q_offset != 0:
                raise ValueError("prefill_attention: the train path takes q_offset 0")
            return ops.FlashAttentionFn.apply(q, k, v, None)
        return ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return attn.chunked_attention(q, k, v, causal=True, q_offset=q_offset, chunk=chunk)


def mla_decode_attention(q_latent: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """MLA absorbed decode over the latent cache (no head axis):
    q_latent (B, H, Dc), q_rope (B, H, Dr), ckv_cache (B, S, Dc),
    krope_cache (B, S, Dr), lengths (B,) -> (B, H, Dc).  The reference
    has no Pallas kernel here, so both devices run the plain version, with
    the reference's one-device f32 combine (``Env.bf16_combine`` off)."""
    return attn.mla_decode_attention(q_latent, q_rope, ckv_cache, krope_cache, lengths,
                                     scale=scale)
