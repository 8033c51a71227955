"""rwkv6-7b — "Finch", attention-free, data-dependent decay [arXiv:2404.05892].

The JAX package's configuration field for field.  No KV cache and no
attention: the per-layer (H, N, N) f32 WKV state and the two token-shift
vectors take the cache's place, O(1) in the sequence length.
"""
from repro_torch.configs.base import RWKV6, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family=RWKV6,
    n_layers=32,
    d_model=4096,
    n_heads=64,           # 4096 / head_dim 64
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    attention_offload=False,
    subquadratic=True,
)
