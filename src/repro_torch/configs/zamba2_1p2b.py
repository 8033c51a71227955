"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

The JAX package's configuration field for field.  38 mamba2 blocks; one
shared (weight-tied) attention+MLP block runs after every
``shared_block_period``-th of them (6 invocation slots) with per-slot
LoRA deltas, seeing [x, x_embed] (2 * d_model): its heads are
2 * 2048 / 32 = 128 wide, not ``head_dim``.  Its K/V caches are ordinary
attention caches; the mamba conv and SSM states ride in the same cache.
"""
from repro_torch.configs.base import ZAMBA2, HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family=ZAMBA2,
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, d_head=64, n_groups=1, d_conv=4, chunk=128, expand=2),
    hybrid=HybridConfig(shared_block_period=6, lora_rank=8, concat_input=True),
    subquadratic=True,
)
