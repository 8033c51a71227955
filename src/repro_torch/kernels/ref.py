"""Plain PyTorch oracles for the attention kernels (naive, O(S^2) memory).

Counterparts of ``repro.kernels.ref.naive_attention`` and
``naive_decode_attention``: the kernel-level plain versions that the
CUDA kernels are held against, and that ``kernels.ops`` runs for CPU
tensors.  Both work in f32 and cast the result to the query's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).  f32 softmax.

    ``q_offset`` places q[:, 0] at an absolute position (chunked-prefill
    continuation); ``None`` keeps the right-aligned causal mask (offset
    ``Sk - Sq``).  A query row with no visible key gives 0, not NaN."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        off = Sk - Sq if q_offset is None else int(q_offset)
        q_pos = off + torch.arange(Sq, device=q.device)[:, None]
        mask = q_pos >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def naive_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """q (B,Hq,D), caches (B,S,Hkv,D), lengths (B,) -> (B,Hq,D).

    Positions at or past ``lengths[b]`` are masked; a row with no valid
    position yields 0 (never NaN)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = (pos[None] < lengths.to(q.device)[:, None])[:, None, None]   # (B,1,1,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / l.clamp_min(1e-30)
    return o.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
