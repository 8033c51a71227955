"""Model configuration of every family the reference defines.

A copy of ``repro.configs.base.ModelConfig`` and its sub-configs
(``MoEConfig``, ``MLAConfig``, ``SSMConfig``, ``RWKVConfig``,
``HybridConfig``) for the dense llama family, the MoE, DeepSeek, RWKV6,
Zamba2 and encoder-decoder families, the stub frontends included, and the
trainer's ``ParallelConfig``, ``TrainConfig`` and ``RunConfig``.  The
reference's shape cells (``ShapeConfig``, ``SHAPES``) are here too: the
serve CLI's balancer plans at one of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

DENSE = "dense"        # llama-style decoder
MOE = "moe"            # moonshot (GQA + MoE FFN)
DEEPSEEK = "deepseek"  # deepseek-v3: MLA + MoE + MTP
RWKV6 = "rwkv6"        # attention-free
ZAMBA2 = "zamba2"      # mamba2 hybrid + shared attention blocks
ENCDEC = "encdec"      # seamless-m4t backbone


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
class SSMConfig:
    d_state: int = 64        # N
    d_head: int = 64         # P (mamba2 head dim)
    n_groups: int = 1        # B/C groups
    d_conv: int = 4
    chunk: int = 128         # chunked-scan block length
    expand: int = 2          # d_inner = expand * d_model


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64     # rank of data-dependent decay LoRA
    mix_lora: int = 32       # rank of token-shift mix LoRA


@dataclass(frozen=True)
class HybridConfig:
    shared_block_period: int = 6   # a shared attention block every N mamba blocks
    lora_rank: int = 8             # per-slot LoRA on the shared block
    concat_input: bool = True      # zamba: shared block sees [x, x_embed0]


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
    # encoder-decoder (seamless)
    n_enc_layers: int = 0
    # multimodal stub frontends: internvl's patch embeddings, prepended to
    # the token embeddings at prefill; seamless's frame embeddings, the
    # encoder's input; both of length ``frontend_len``
    frontend: str = "none"             # none | patches | frames
    frontend_len: int = 0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    hybrid: HybridConfig | None = None
    mtp_depth: int = 0                 # deepseek multi-token-prediction heads
    dtype: str = "bfloat16"
    kv_quant: bool = False             # int8 dense KV cache with bf16 scales: 2x capacity
    # applicability of the paper's technique
    attention_offload: bool = True     # False for attention-free archs
    subquadratic: bool = False         # True -> runs long_500k

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded to a multiple of ``multiple``; the pad logits are
        masked at unembed and the pad rows are never looked up."""
        return -(-self.vocab // multiple) * multiple

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input shapes (the reference's cells; the balancer plans at decode_32k)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# run / parallelism config (the reference's, field for field; training reads
# ``zero_stage`` on a mesh, as the reference's trainer does, and carries
# ``kv_policy``, ``offload``, ``sub_batches``, ``sequence_parallel`` and
# ``remat`` unread, as the reference's trainer does too)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ParallelConfig:
    kv_policy: str = "batch"        # "batch" | "head"   (paper Fig. 4)
    offload: str = "hpu"            # "hpu" (disaggregated) | "none" (baseline)
    sub_batches: int = 2            # sub-batch pipelining factor (paper Fig. 3)
    sequence_parallel: bool = False # beyond-paper: SP for train/prefill
    zero_stage: int = 1             # 0: replicated opt state, 1: sharded over data
    remat: str = "block"            # "none" | "block" | "full"
    grad_accum: int = 1
    grad_compression: str = "none"  # "none" | "int8"
    grad_accum_dtype: str = "float32"  # accumulator/wire dtype ("bfloat16" halves AR bytes)
    optimizer_dtype: str = "float32"  # adam moments dtype ("bfloat16" for huge models)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"   # "cosine" | "wsd" (minicpm) | "const"
    warmup_steps: int = 100
    total_steps: int = 1000
    stable_frac: float = 0.8   # WSD stable phase fraction


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
