"""Plain PyTorch oracles for the attention kernels (naive, O(S^2) memory).

Counterparts of ``repro.kernels.ref``: the per-vector KV quantizer
(:data:`KV_DTYPES`, :func:`kv_quantize`, :func:`kv_dequantize`),
``naive_attention``, ``naive_decode_attention``, ``gather_paged_cache``,
``gather_paged_scales``, ``paged_decode_attention`` (with the fp8/int8
pools' scales) and ``lse_merge``: the kernel-level plain versions that
the CUDA kernels are held against, and that ``kernels.ops`` runs for
CPU tensors.  They work in f32 and cast the result to the query's dtype.
The quantizer gives the reference's bytes (as the reference runs it,
jitted): torch and JAX cast to fp8-e4m3 identically, and ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

# kv_dtype name -> (storage dtype, absmax quantization range)
KV_DTYPES = {
    "fp8": (torch.float8_e4m3fn, 448.0),
    "int8": (torch.int8, 127.0),
}


def kv_quantize(x: torch.Tensor, kv_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector absmax quantization over the trailing (head_dim) axis:
    ``x (..., D)`` -> ``(payload (..., D) int8|fp8, scale (...) f32)``
    with ``payload * scale ~= x``.  An all-zero vector gets scale 0 (and
    payload 0).  int8 rounds half to even and clips to +-127.

    The scale is ``amax * f32(1 / qmax)``: that is what the reference's
    ``amax / qmax`` compiles to under ``jax.jit`` (XLA turns a division by
    a constant into a multiplication), and every caller in the reference
    runs it jitted.  Evaluated eagerly it would differ in the last bit of
    about half the scales."""
    dtype, qmax = KV_DTYPES[kv_dtype]
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * (1.0 / qmax)
    q = xf / scale[..., None].clamp_min(1e-30)
    if kv_dtype == "int8":
        q = torch.round(q).clamp(-qmax, qmax)
    return q.to(dtype), scale


def kv_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: ``payload (..., D) * scale (...)``
    -> ``(..., D)`` in ``out_dtype``."""
    return (payload.float() * scale[..., None].float()).to(out_dtype)


def lse_merge(parts: list) -> torch.Tensor:
    """Combine partial attention outputs over disjoint KV windows.

    ``parts`` is a list of ``(out (B, Hq, D), lse (B, Hkv, G))`` pairs,
    each normalized over its own window; the exact combined attention is
    their lse-softmax-weighted sum.  An empty window (``lse <= -1e30``)
    gets weight ~0; if every window is empty the result is 0, not NaN."""
    outs = torch.stack([o.float() for o, _ in parts])                  # (P,B,Hq,D)
    lses = torch.stack([l.float() for _, l in parts])                  # (P,B,Hkv,G)
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    w = w / w.sum(dim=0).clamp_min(1e-30)[None]
    P, B, Hkv, G = lses.shape
    return (outs * w.reshape(P, B, Hkv * G, 1)).sum(dim=0).to(parts[0][0].dtype)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int | torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,    # (B, Sk, Hkv) f32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).  f32 softmax.

    ``q_offset`` places q[:, 0] at an absolute position (chunked-prefill
    continuation): an int or a one-element tensor, read without a host
    sync; ``None`` keeps the right-aligned causal mask (offset
    ``Sk - Sq``).  ``k_scale``/``v_scale`` dequantize int8/fp8 K/V
    payloads per stored vector.  A query row with no visible key gives 0,
    not NaN."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        off = Sk - Sq if q_offset is None else q_offset
        if isinstance(off, torch.Tensor):
            off = off.reshape(()).to(q.device)
        q_pos = off + torch.arange(Sq, device=q.device)[:, None]
        mask = q_pos >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int | torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Row log-sum-exp of :func:`naive_attention`'s scaled scores, natural
    log: ``(B, Hq, Sq)`` f32, ``log(sum_k exp(scale * q.k))`` over each
    row's visible keys (a row with none gives about -1e30)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf = k.float() if k_scale is None else k.float() * k_scale.float()[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, Sq, Hkv, G, D), kf) * scale
    if causal:
        off = Sk - Sq if q_offset is None else q_offset
        if isinstance(off, torch.Tensor):
            off = off.reshape(()).to(q.device)
        q_pos = off + torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(q_pos < torch.arange(Sk, device=q.device)[None, :], NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def naive_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    starts: torch.Tensor | None = None,
    return_lse: bool = False,
    shared_max=None,
):
    """q (B,Hq,D), caches (B,S,Hkv,D), lengths (B,) -> (B,Hq,D).

    Positions at or past ``lengths[b]`` are masked, and below
    ``starts[b]`` when given (a hot attention window); ``return_lse``
    also returns the per-row log-sum-exp ``(B, Hkv, G)`` f32.  A row with
    no valid position yields output 0 and lse <= -1e30 (never NaN).
    ``shared_max`` maps the rows' score maxima ``(B, Hkv, G, 1)`` to the
    maxima the softmax subtracts: a window of a pool split across ranks
    takes the maximum over every window (an all-reduce), so that p is
    what one softmax over the whole row gives."""
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
    if shared_max is not None:
        m = shared_max(m)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / l.clamp_min(1e-30)
    out = o.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
    if return_lse:
        lse = m + torch.log(l.clamp_min(1e-30))
        if shared_max is not None:
            lse = torch.where(l > 0, lse, NEG_INF)
        return out, lse[..., 0]
    return out


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (a uint8 view), any other as it is.
    Gathers from and scatters into fp8 pools go through it, so they move
    the same bytes without relying on fp8 indexing kernels."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _take_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """``pool[block_tables]``, gathered through :func:`byte_view`."""
    return byte_view(pool)[block_tables.long()].view(pool.dtype)


def gather_paged_cache(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Kernel-native pool (N, Hkv, bs, D) + tables (B, MB) -> contiguous
    dense-layout cache (B, MB*bs, Hkv, D), positions in logical order."""
    _, Hkv, bs, D = pool.shape
    B, MB = block_tables.shape
    return _take_blocks(pool, block_tables).transpose(2, 3).reshape(B, MB * bs, Hkv, D)


def gather_paged_scales(spool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Scale pool (N, Hkv, bs) + tables (B, MB) -> dense-layout scales
    (B, MB*bs, Hkv)."""
    _, Hkv, bs = spool.shape
    B, MB = block_tables.shape
    return spool[block_tables.long()].transpose(2, 3).reshape(B, MB * bs, Hkv)


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
    k_scale: torch.Tensor | None = None,    # (N, Hkv, bs) f32
    v_scale: torch.Tensor | None = None,
):
    """Oracle of the paged kernel: gather each row's blocks into a
    contiguous cache, dequantize it with the gathered scales when the
    pool is fp8/int8, then the dense decode oracle.  Positions past
    ``lengths`` (whatever the null block holds) and below ``starts`` are
    masked there."""
    k = gather_paged_cache(k_pool, block_tables).float()
    v = gather_paged_cache(v_pool, block_tables).float()
    if k_scale is not None:
        k = k * gather_paged_scales(k_scale, block_tables)[..., None]
        v = v * gather_paged_scales(v_scale, block_tables)[..., None]
    return naive_decode_attention(q, k, v, lengths, scale=scale, starts=starts,
                                  return_lse=return_lse)
