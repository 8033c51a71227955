"""Model configuration (dense family).

A copy of the fields of ``repro.configs.base.ModelConfig`` that the dense
llama-family serving path reads; the other families' sub-configs arrive
with their slices of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

DENSE = "dense"        # llama-style decoder


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    max_seq: int = 4096
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_quant: bool = False             # int8 KV cache: not ported yet

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded to a multiple of ``multiple``; the pad logits are
        masked at unembed and the pad rows are never looked up."""
        return -(-self.vocab // multiple) * multiple

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
