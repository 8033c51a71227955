"""Token sampling (greedy / temperature / top-k) in PyTorch.

Counterpart of ``repro.serving.sampler`` (``SamplerConfig``,
``sample_on_device``, ``sample``, and speculation's
``spec_draft_sample`` / ``spec_verify_tokens``), two entry points with
one semantics:

* :func:`sample_on_device` — stays on the tensor's device and never
  waits on it (Gumbel-max over the transformed logits), so the async
  engine's fused step returns ``(B,)`` ids without a host round trip;
* :func:`sample` — the host-side oracle the synchronous engine uses, an
  independent implementation (``torch.multinomial`` over the softmax).

Greedy is an argmax (first index on ties, like ``jnp.argmax``) and
matches the reference token for token.  On a mesh each rank samples its
rows of the batch (``rows``) and draws the whole batch's random numbers,
so every rank's generator advances alike and a row's draw does not
depend on how the batch is split.  Random draws come from an
explicit ``torch.Generator``; they cannot reproduce ``jax.random``'s
stream, so temperature and top-k are compared by distribution.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> no truncation


def _transformed(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Logits of the sampling distribution: scaled by 1/temperature, with
    everything below the k-th largest set to -inf when ``top_k > 0``."""
    scaled = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    return scaled


def sample_on_device(logits: torch.Tensor, generator: torch.Generator | None,
                     cfg: SamplerConfig, rows: tuple[int, int, int] | None = None
                     ) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32 on the logits' device.  ``rows``
    ``(lo, hi, n)``: the logits are rows ``[lo, hi)`` of an ``n``-row
    batch (a rank's share on a mesh)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _transformed(logits, cfg)
    return _categorical(scaled, generator, rows)


def _categorical(logits: torch.Tensor, generator: torch.Generator | None,
                 rows: tuple[int, int, int] | None = None) -> torch.Tensor:
    """One draw per row of ``softmax(logits)`` by Gumbel-max, on the
    logits' device with no host sync; with ``rows`` the draws of rows
    ``[lo, hi)`` of an ``n``-row batch."""
    if rows is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
    else:
        lo, hi, n = rows
        u = torch.rand((n, logits.shape[-1]), generator=generator, device=logits.device)[lo:hi]
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def spec_draft_sample(logits: torch.Tensor, generator: torch.Generator | None,
                      cfg: SamplerConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Draft proposal for one speculative position: logits (B, V) ->
    (token (B,) int32, probs (B, V) f32 or None for greedy).  ``probs`` is
    the distribution the token was drawn from, which rejection sampling
    divides by."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32), None
    scaled = _transformed(logits, cfg)
    return _categorical(scaled, generator), torch.softmax(scaled, dim=-1)


def spec_verify_tokens(logits: torch.Tensor, drafts: torch.Tensor | None,
                       draft_probs: torch.Tensor | None,
                       generator: torch.Generator | None,
                       cfg: SamplerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept or reject k draft tokens against the target's verify logits.

    ``logits`` (B, T, V), T = k + 1, position ``t`` scoring the successor
    of verify input ``t``; ``drafts`` (B, k) int32 (None when k = 0);
    ``draft_probs`` (B, k, V) (None for greedy).  Returns ``(emitted (B, T)
    int32, n_accept (B,) int32)``: positions ``0 .. n_accept`` of
    ``emitted`` are the step's tokens, later ones garbage.

    Greedy accepts while the draft equals the target's argmax, so the
    stream is token-identical to plain greedy decoding.  Otherwise draft
    ``d`` is accepted when ``u * p_d(d) < p_t(d)``, and the first rejected
    position is resampled from ``max(p_t - p_d, 0)`` (``p_t`` where that is
    all zero); a fully accepted window's bonus token comes from ``p_t``
    through a zero draft row.  Every emitted token is then an exact sample
    of the target's (temperature, top-k) distribution.  All on the
    device, with no host sync."""
    B, T, V = logits.shape
    k = T - 1
    if cfg.temperature <= 0.0:
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)             # (B, T)
        if k == 0:
            return tgt, torch.zeros(B, dtype=torch.int32, device=logits.device)
        match = (drafts == tgt[:, :k]).to(torch.int32)
        return tgt, torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    p_t = torch.softmax(_transformed(logits, cfg), dim=-1)              # (B, T, V)
    bidx = torch.arange(B, device=logits.device)
    if k > 0:
        d = drafts.long()[..., None]
        p_t_d = torch.gather(p_t[:, :k], -1, d)[..., 0]
        p_d_d = torch.gather(draft_probs, -1, d)[..., 0]
        u = torch.rand((B, k), generator=generator, device=logits.device)
        # u < p_t / p_d, multiplied out so that p_d -> 0 stays finite
        accept = (u * p_d_d < p_t_d).to(torch.int32)
        n_accept = torch.cumprod(accept, dim=1).sum(dim=1)
        q_pad = torch.cat([draft_probs, draft_probs.new_zeros(B, 1, V)], dim=1)
        emitted = torch.cat([drafts.to(torch.int32), drafts.new_zeros(B, 1, dtype=torch.int32)],
                            dim=1)
    else:
        n_accept = torch.zeros(B, dtype=torch.int64, device=logits.device)
        q_pad = torch.zeros_like(p_t)
        emitted = torch.zeros(B, 1, dtype=torch.int32, device=logits.device)
    p_a = p_t[bidx, n_accept]                                           # (B, V)
    resid = (p_a - q_pad[bidx, n_accept]).clamp_min(0.0)
    denom = resid.sum(dim=-1, keepdim=True)
    # an exhausted residual (p_t == p_d pointwise) falls back to p_t
    resid = torch.where(denom > 0, resid / denom.clamp_min(1e-30), p_a)
    emitted[bidx, n_accept] = _categorical(torch.log(resid + 1e-30), generator)
    return emitted, n_accept.to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplerConfig) -> torch.Tensor:
    """Host oracle: logits (B, V) -> tokens (B,) int32 on the CPU."""
    logits = logits.detach().cpu()
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_transformed(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
