"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

The JAX package's configuration field for field: GQA 16 heads, kv 16,
expert dim 1408, the Moonlight shared experts (2) and a single leading
dense layer with d_ff = d_expert * (top_k + n_shared) = 11264.
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,           # dense-layer FFN dim (= 1408 * 8)
    vocab=163840,
    head_dim=128,
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_expert=1408,
        score_func="sigmoid",
        moe_layer_start=1,
    ),
)
