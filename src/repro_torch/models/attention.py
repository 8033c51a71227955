"""Attention compute paths in plain PyTorch (model level).

Counterparts of ``repro.models.attention.chunked_attention`` and
``decode_attention``: the plain versions that the reference engine's
numerics run through, cast for cast, so that CPU logits agree with the
JAX engine.  ``core.offload`` runs these for CPU tensors and the CUDA
kernels for GPU tensors.

Shapes:
  q        (B, Sq, Hq, D)
  k, v     (B, Sk, Hkv, D)        Hq % Hkv == 0 (GQA group G = Hq // Hkv)
  output   (B, Sq, Hq, D)

A bf16 ``matmul`` in torch rounds its output to bf16, which JAX's
``preferred_element_type=f32`` does not; so bf16 operands are upcast to
f32 before every product here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import acc_dtype


def _pick_chunk(sk: int, want: int) -> int:
    c = min(want, sk)
    while sk % c:
        c -= 1
    return max(c, 1)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, f32 accumulation (f64 for
    f64 inputs: :func:`common.acc_dtype`).

    ``q_offset``: absolute position of q[:, 0] (int or (B,))."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    chunk = _pick_chunk(Sk, chunk)
    dev, dt = q.device, acc_dtype(q)

    qf = q.to(dt).reshape(B, Sq, Hkv, G, D) * scale
    off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev).expand(B)
    q_pos = off[:, None] + torch.arange(Sq, device=dev)[None, :]        # (B,Sq)

    m = torch.full((B, Sq, Hkv, G), float("-inf"), dtype=dt, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=dt, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, Dv), dtype=dt, device=dev)
    for j in range(Sk // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].to(dt)
        vj = v[:, j * chunk:(j + 1) * chunk].to(dt)
        s = torch.einsum("bqhgd,bchd->bqhgc", qf, kj)
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        mask = torch.ones((B, Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, :, None] >= k_pos[None, None, :]
        mask5 = mask[:, :, None, None, :]
        s = s.masked_fill(~mask5, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask5, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, vj)
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                  scale: float | None = None) -> torch.Tensor:
    """The scaled scores of one query token, f32 ``(B, Hkv, G, S)``,
    ``-inf`` at or past ``lengths``: q·scale rounded to the working dtype
    before the product, as the reference casts."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q.float() * scale).to(q.dtype).float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    mask = (torch.arange(S, device=q.device)[None] < lengths[:, None])[:, None, None]
    return s.masked_fill(~mask, float("-inf"))


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    m: torch.Tensor | None = None,
    return_lse: bool = False,
):
    """One-token attention against a partially filled KV cache.

    q (B, Hq, D); caches (B, S, Hkv, D); lengths (B,).  The new token's
    K/V must already be in the cache at index ``lengths - 1``.  Mirrors
    the reference's casts: q·scale is rounded to the working dtype before
    the product, and p is cast to the cache dtype before P·V; both
    products accumulate in f32.

    ``m`` (B, Hkv, G, 1), when given, is the maximum the softmax
    subtracts instead of the row's own: a window of a cache split by
    positions passes the maximum over every window, so that p rounds as
    in one softmax over the whole cache.  ``return_lse`` also returns the
    window's log-sum-exp (B, Hkv, G) f32, <= -1e30 for a row with no
    position, for the merge of the windows."""
    B, Hq, _ = q.shape
    Dv = v_cache.shape[-1]
    s = decode_scores(q, k_cache, lengths, scale=scale)
    mask = torch.isfinite(s)
    if m is None:
        m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v_cache.dtype).float()
    o = torch.einsum("bhgk,bkhd->bhgd", pv, v_cache.float())
    o = (o / l.clamp_min(1e-30)).reshape(B, Hq, Dv).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), -1e30)
    return o, lse[..., 0]


def mla_decode_attention(
    q_latent: torch.Tensor,
    q_rope: torch.Tensor,
    ckv_cache: torch.Tensor,
    krope_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """DeepSeek MLA absorbed decode over the latent cache.

    q_latent (B, H, Dc): the query projected into the compressed-KV
    latent space (W_UK absorbed); q_rope (B, H, Dr); ckv_cache (B, S, Dc);
    krope_cache (B, S, Dr); lengths (B,) -> (B, H, Dc), the
    attention-weighted latent (the caller applies W_UV and W_O).  The
    reference's casts: the queries are rounded to the caches' dtype, the
    scores are f32 sums of those products, p is rounded to the cache
    dtype before P·ckv, whose sum and the division by l run in f32 (the
    reference's ``acc_dtype`` on one device: its bf16 combine is a
    cross-shard option).  Every product runs on f32 operands that hold the
    rounded values (exact), so a bf16 matmul's own output rounding never
    enters (TF32 must be off on the card)."""
    S = ckv_cache.shape[1]
    ckv = ckv_cache.float()
    ql = q_latent.to(ckv_cache.dtype).float()
    qr = q_rope.to(krope_cache.dtype).float()
    s = torch.bmm(ql, ckv.transpose(1, 2))
    s = s + torch.bmm(qr, krope_cache.float().transpose(1, 2))
    s = s * scale
    mask = (torch.arange(S, device=s.device)[None] < lengths[:, None])[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.bmm(p.to(ckv_cache.dtype).float(), ckv)
    out = out / l.clamp_min(1e-30)
    return out.to(q_latent.dtype)
