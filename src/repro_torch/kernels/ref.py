"""Plain PyTorch oracles for the attention kernels (naive, O(S^2) memory).

Counterparts of ``repro.kernels.ref.naive_attention``,
``naive_decode_attention``, ``gather_paged_cache`` and
``paged_decode_attention`` (without the quantized pools' scales): the
kernel-level plain versions that the CUDA kernels are held against, and
that ``kernels.ops`` runs for CPU tensors.  They work in f32 and cast
the result to the query's dtype.
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
    starts: torch.Tensor | None = None,
    return_lse: bool = False,
):
    """q (B,Hq,D), caches (B,S,Hkv,D), lengths (B,) -> (B,Hq,D).

    Positions at or past ``lengths[b]`` are masked, and below
    ``starts[b]`` when given (a hot attention window); ``return_lse``
    also returns the per-row log-sum-exp ``(B, Hkv, G)`` f32.  A row with
    no valid position yields output 0 and lse <= -1e30 (never NaN)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos[None] < lengths.to(q.device)[:, None]                    # (B,S)
    if starts is not None:
        valid &= pos[None] >= starts.to(q.device)[:, None]
    mask = valid[:, None, None]                                          # (B,1,1,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / l.clamp_min(1e-30)
    out = o.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out


def gather_paged_cache(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Kernel-native pool (N, Hkv, bs, D) + tables (B, MB) -> contiguous
    dense-layout cache (B, MB*bs, Hkv, D), positions in logical order."""
    _, Hkv, bs, D = pool.shape
    B, MB = block_tables.shape
    return pool[block_tables.long()].transpose(2, 3).reshape(B, MB * bs, Hkv, D)


def paged_decode_attention(
    q: torch.Tensor,             # (B, Hq, D)
    k_pool: torch.Tensor,        # (N, Hkv, bs, D) — kernel-native
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MB) int32
    lengths: torch.Tensor,       # (B,)
    *,
    scale: float | None = None,
    starts: torch.Tensor | None = None,
    return_lse: bool = False,
):
    """Oracle of the paged kernel: gather each row's blocks into a
    contiguous cache, then the dense decode oracle.  Positions past
    ``lengths`` (whatever the null block holds) and below ``starts`` are
    masked there."""
    k = gather_paged_cache(k_pool, block_tables).float()
    v = gather_paged_cache(v_pool, block_tables).float()
    return naive_decode_attention(q, k, v, lengths, scale=scale, starts=starts,
                                  return_lse=return_lse)
