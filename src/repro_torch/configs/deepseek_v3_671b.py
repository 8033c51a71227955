"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8) + MTP
[arXiv:2412.19437].

The JAX package's configuration field for field.  d_ff 18432 is the
dense-layer FFN dim (= d_expert * (top_k + n_shared)) of the first
``moe_layer_start`` layers; the per-expert dim is 2048.  The decode cache
is the compressed latent (kv_lora 512 + rope 64 per position), read by
the absorbed formulation.
"""
from repro_torch.configs.base import DEEPSEEK, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family=DEEPSEEK,
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,       # MLA: all heads read the shared latent cache
    d_ff=18432,           # dense-layer FFN dim (= 2048 * 9)
    vocab=129280,
    head_dim=128,         # v head dim; qk dims come from MLAConfig
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_expert=2048,
        score_func="sigmoid",
        moe_layer_start=3,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
)
