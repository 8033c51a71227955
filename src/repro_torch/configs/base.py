"""Model configuration (dense, MoE and DeepSeek families).

A copy of the fields of ``repro.configs.base.ModelConfig`` (and of its
``MoEConfig`` and ``MLAConfig``) that the dense llama-family, the MoE and
the DeepSeek serving paths read, the stub frontend's included; the other
families' sub-configs arrive with their slices of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

DENSE = "dense"        # llama-style decoder
MOE = "moe"            # moonshot (GQA + MoE FFN)
DEEPSEEK = "deepseek"  # deepseek-v3: MLA + MoE + MTP


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared: int = 0               # shared (always-on) experts
    d_expert: int = 0               # per-expert FFN hidden dim
    router_aux_coef: float = 0.001  # load-balance aux loss
    router_dtype: str = "float32"
    capacity_factor: float = 1.25   # dropping MoE capacity (tests may raise)
    score_func: str = "softmax"     # softmax | sigmoid (dsv3 uses sigmoid)
    moe_layer_start: int = 0        # dense layers before MoE starts (dsv3: 3)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    # multimodal stub frontend (internvl patches): embeddings of length
    # ``frontend_len`` prepended to the token embeddings at prefill
    frontend: str = "none"             # none | patches
    frontend_len: int = 0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp_depth: int = 0                 # deepseek multi-token-prediction heads
    dtype: str = "bfloat16"
    kv_quant: bool = False             # int8 dense KV cache with bf16 scales: 2x capacity

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded to a multiple of ``multiple``; the pad logits are
        masked at unembed and the pad rows are never looked up."""
        return -(-self.vocab // multiple) * multiple

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
