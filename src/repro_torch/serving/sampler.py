"""Token sampling (greedy / temperature / top-k) in PyTorch.

Counterpart of ``repro.serving.sampler`` (``SamplerConfig``,
``sample_on_device``, ``sample``), two entry points with one semantics:

* :func:`sample_on_device` — stays on the tensor's device and never
  waits on it (Gumbel-max over the transformed logits), so the async
  engine's fused step returns ``(B,)`` ids without a host round trip;
* :func:`sample` — the host-side oracle the synchronous engine uses, an
  independent implementation (``torch.multinomial`` over the softmax).

Greedy is an argmax (first index on ties, like ``jnp.argmax``) and
matches the reference token for token.  Random draws come from an
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
                     cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32 on the logits' device."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _transformed(logits, cfg)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplerConfig) -> torch.Tensor:
    """Host oracle: logits (B, V) -> tokens (B,) int32 on the CPU."""
    logits = logits.detach().cpu()
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_transformed(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
